"""The port's native (C++) host code: the input pipeline
(``pipeline.cc``), built with g++ at its first call by ``ops/_build.py``
and bound with ctypes in ``pipeline.py``."""
