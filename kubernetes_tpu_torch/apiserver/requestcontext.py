"""Per-request context: the authenticated user visible to admission.

The reference passes user.Info into every admission.Attributes
(apiserver/pkg/admission/attributes.go); in this build requests run on
the caller's thread end-to-end, so a thread-local carries the identity
from the secured facade (auth.py _gated) down into the admission chain —
NodeRestriction is the consumer."""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_local = threading.local()


def current_user():
    """UserInfo of the request being served on this thread, or None for
    in-proc/loopback callers (which bypass authn, like the reference's
    loopback client)."""
    return getattr(_local, "user", None)


@contextlib.contextmanager
def request_user(user):
    prev = getattr(_local, "user", None)
    _local.user = user
    try:
        yield
    finally:
        _local.user = prev
