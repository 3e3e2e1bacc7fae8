from . import acquisition, loop, problems  # noqa: F401
