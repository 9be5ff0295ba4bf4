"""Request-level query scheduling (the JAX package's sched/): when to
hold concurrent arrivals so they reach the card as one launch (the
adaptive batching window), whether a request can meet its deadline at
all (admission: 429 + Retry-After instead of queuing dead work), and
who goes next when tenants compete (weighted fair queues keyed by the
X-Pilosa-Tenant header)."""

from .scheduler import AdmissionError, QueryScheduler

__all__ = ["AdmissionError", "QueryScheduler"]
