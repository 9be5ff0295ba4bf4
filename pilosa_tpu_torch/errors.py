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


class QueryError(PilosaError):
    """Invalid query arguments/shape."""


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
