"""Kind ``serve_closed``: its tiny sizes and its planted faults."""

from benchmark.tests.kinds.serving import FAULTS, SERVE  # noqa: F401

TINY = {**SERVE, "traffic": {"clients": 6, "profile_s": 0.5}}
