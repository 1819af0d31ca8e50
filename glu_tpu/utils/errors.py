"""Fail-fast error checks.

JAX analog of reference glu/errors.hpp:8-18 (GLU_CHECK_STATE,
GLU_CHECK_ARGUMENT, GLU_FAIL). The reference prints to stderr and exits the
process; in a Python/JAX host we raise typed exceptions instead, which is the
idiomatic fail-fast for a library that does not own the process.
"""

from __future__ import annotations


class GluError(RuntimeError):
    """Base error for glu_tpu precondition violations."""


class GluStateError(GluError):
    """An internal state invariant was violated (analog of GLU_CHECK_STATE)."""


class GluArgumentError(GluError, ValueError):
    """A user-supplied argument was invalid (analog of GLU_CHECK_ARGUMENT)."""


def fail(fmt: str, *args) -> None:
    """Unconditional failure (analog of GLU_FAIL, reference glu/errors.hpp:17)."""
    raise GluError(fmt % args if args else fmt)


def check_state(cond: bool, fmt: str = "state check failed", *args) -> None:
    """Analog of GLU_CHECK_STATE (reference glu/errors.hpp:8-11)."""
    if not cond:
        raise GluStateError(fmt % args if args else fmt)


def check_argument(cond: bool, fmt: str = "invalid argument", *args) -> None:
    """Analog of GLU_CHECK_ARGUMENT (reference glu/errors.hpp:12-15)."""
    if not cond:
        raise GluArgumentError(fmt % args if args else fmt)
