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
