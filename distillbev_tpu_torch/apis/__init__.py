from .test import run_eval

__all__ = ["run_eval"]
