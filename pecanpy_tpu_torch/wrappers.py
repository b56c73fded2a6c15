"""Timing utilities.

Copied from ``pecanpy_tpu/wrappers.py`` (that package cannot be imported
without jax). Behavioral parity with the reference ``Timer`` decorator
(``src/pecanpy/wrappers.py:5-27``): prints ``Took HH:MM:SS.ss to <name>``
after the wrapped call completes; silent when ``verbose`` is False.
"""
import time
from functools import wraps


class Timer:
    """Decorator that reports wall-clock time of the wrapped call."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose

    def __call__(self, func):
        @wraps(func)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            result = func(*args, **kwargs)
            if self.verbose:
                elapsed = time.perf_counter() - t0
                hrs, rem = divmod(elapsed, 3600)
                mins, secs = divmod(rem, 60)
                print(f"Took {int(hrs):02d}:{int(mins):02d}:{secs:05.2f} to {self.name}")
            return result

        return timed
