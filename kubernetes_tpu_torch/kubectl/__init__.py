from .cli import Kubectl, main

__all__ = ["Kubectl", "main"]
