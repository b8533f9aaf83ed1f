"""ktpu-lint: AST invariant analysis for the hand-enforced contracts.

Stdlib-only (``ast`` + ``tokenize``); never imports the code it checks.
Entry points: ``scripts/lint.py`` (CLI) and
``tests/test_static_analysis.py`` (tier-1 gate).
The port's copy lints kubernetes_tpu_torch/: its entry points are
``python -m kubernetes_tpu_torch.analysis`` (CLI) and
``tests/test_torch_static_analysis.py``.
"""

from .core import (Report, Violation, load_baseline, run,  # noqa: F401
                   save_baseline, update_baseline)
