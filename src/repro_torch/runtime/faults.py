"""Fault taxonomy and recovery policy of the non-blocking runtime.

The part of the JAX package's ``repro.runtime.faults`` that the driver
uses without a retry supervisor: the exception types it raises and the
``RecoveryConfig`` whose ``max_consecutive_nonfinite`` sets how many
guard trips in a row escalate to a rewind. The chaos injector, the fault
plan and the retry supervisor are not ported yet (ROADMAP Queue 1 item
13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class FaultError(RuntimeError):
    """Base of every fault-runtime exception."""


class NonFiniteEscalation(FaultError):
    """The guarded step tripped ``max_consecutive_nonfinite`` times in a
    row: skipping is no longer converging; rewind to the last good
    checkpoint."""


class PrefetchStalled(FaultError):
    """The background prefetch thread died or stopped producing within
    its bounded wait. ``cause`` carries the thread's own exception when
    one was captured."""

    def __init__(self, msg: str, cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.cause = cause


@dataclass(frozen=True)
class RecoveryConfig:
    """The driver's recovery policy. ``max_consecutive_nonfinite`` is N of
    the guarded step's escalation rule: N consecutive tripped steps raise
    :class:`NonFiniteEscalation`. The retry supervisor's per-class budgets
    and backoff come with the supervisor (ROADMAP Queue 1 item 13)."""

    max_consecutive_nonfinite: int = 3
