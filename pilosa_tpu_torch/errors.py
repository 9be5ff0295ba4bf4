"""Framework error types (the subset of pilosa_tpu/errors.py this port
raises). The HTTP layer maps them to status codes."""


class PilosaError(Exception):
    """Base class for framework errors."""


class IndexRequiredError(PilosaError):
    def __init__(self):
        super().__init__("index required")


class IndexNotFoundError(PilosaError):
    def __init__(self):
        super().__init__("index not found")


class IndexExistsError(PilosaError):
    def __init__(self):
        super().__init__("index already exists")


class FrameNotFoundError(PilosaError):
    def __init__(self):
        super().__init__("frame not found")


class FrameExistsError(PilosaError):
    def __init__(self):
        super().__init__("frame already exists")


class FragmentNotFoundError(PilosaError):
    def __init__(self):
        super().__init__("fragment not found")


class QueryError(PilosaError):
    """Invalid query arguments/shape."""


class SliceUnavailableError(PilosaError):
    """A slice's data cannot be read. The HTTP layer answers 500 with
    the message."""

    def __init__(self, msg: str = "slice unavailable"):
        super().__init__(msg)


class CorruptFragmentError(SliceUnavailableError):
    """A fragment's file failed integrity verification (a footer CRC, a
    container checksum, a damaged op record in the middle of the log).
    The fragment raises it on every touch and leaves the file in place:
    it never serves the rot and never replaces it with an empty image,
    whose next snapshot would bury the real data. One node has no
    replica to repair it from (the cluster's read-repair waits for the
    port's cluster layer)."""

    def __init__(self, msg: str = "fragment corrupt"):
        super().__init__(msg)


class DeadlineExceededError(PilosaError):
    """The query's deadline expired: before or during admission, while
    queued, or between its calls. HTTP 504."""


class WriteBackpressureError(PilosaError):
    """A write was shed: the fragment's ops not yet covered by a
    snapshot passed max_wal_ops, and no snapshot landed within the
    backpressure deadline. The HTTP layer answers 503 with Retry-After;
    the condition clears when the snapshot lands."""

    transient = True

    def __init__(self, msg: str = "write backpressure: WAL bound exceeded",
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeviceResourceError(PilosaError):
    """The card could not serve a query within its memory budget: one
    staged view alone exceeds the HBM budget (`reason="hbm_infeasible"`),
    the card ran out of memory even after every unpinned view was
    evicted (`reason="oom"`), or the query's plan signature is
    quarantined after repeated device failures (`reason="quarantined"`).
    The executor answers that one query on the host instead; the
    manager counts it as `fallback_<reason>`."""

    transient = True

    def __init__(self, msg: str, reason: str = "oom"):
        super().__init__(msg)
        self.reason = reason
