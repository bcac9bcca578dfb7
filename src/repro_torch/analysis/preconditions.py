"""Precondition catalog: one message source for the runtime ``ValueError``s
of the ring schedules (copy of the runtime part of
``repro.analysis.preconditions``).

Each precondition is a ``check_*`` function returning its message, or None
when it holds; :func:`require` turns a message into the ``ValueError``.  The
messages are the reference's, word for word.  The static findings
(``finding``) wait for the port of ``analysis/report.py``.
"""

from __future__ import annotations

__all__ = ["require", "check_even_split", "check_zigzag_divisible"]


def require(message: str | None) -> None:
    """Raise the catalog message as the runtime ``ValueError`` (no-op on None)."""
    if message is not None:
        raise ValueError(message)


def check_even_split(S_loc: int, *, what: str, who: str, alternative: str) -> str | None:
    """PRE-EVEN-SPLIT: bidirectional schedules halve a local shard.

    ``what`` names the split tensor ("Q block" / "KV shard"), ``who`` the
    strategy spelling used in the message, ``alternative`` the escape hatch.
    """
    if S_loc % 2 == 0:
        return None
    return (
        f"{who} splits the local {what} across the two ring directions and "
        f"needs an even local length; got S_loc={S_loc} — pad the sequence "
        f"or use {alternative}"
    )


def check_zigzag_divisible(S: int, P: int) -> str | None:
    """PRE-ZIGZAG-DIV: the balanced causal layout needs 2 chunks per rank."""
    if S % (2 * P) == 0:
        return None
    return (
        f"zigzag layout needs the sequence length divisible by 2P "
        f"(2 chunks per rank); got S={S}, P={P} — pad the sequence to a "
        f"multiple of {2 * P} or use layout='contig'"
    )
