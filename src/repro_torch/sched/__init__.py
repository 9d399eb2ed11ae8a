"""Persistent multi-tenant scheduler: a stream of PTGs, one live DAG.

The port's copy of the JAX package's ``repro.sched``, with every block
store, namespace version and result a tensor on the service's device
(``cuda`` unless the caller passes ``device="cpu"``). Entry point:
:class:`SchedulerService` (see :mod:`repro_torch.sched.service`).
"""

from .fair import FairPolicy
from .namespace import NamespaceShard
from .service import (Client, DeadlineExceeded, RetryingFuture,
                      SchedulerService, Submission, SubmissionError,
                      SubmissionFuture)
from .state import LiveStats, SubmissionShard, TaskState

__all__ = [
    "Client",
    "DeadlineExceeded",
    "FairPolicy",
    "LiveStats",
    "NamespaceShard",
    "RetryingFuture",
    "SchedulerService",
    "Submission",
    "SubmissionError",
    "SubmissionFuture",
    "SubmissionShard",
    "TaskState",
]
