"""The port's native (C++) host code, built with g++ at its first call by
``ops/_build.py`` and bound with ctypes: the input pipeline (``pipeline.cc``
in ``pipeline.py``) and the Paikin-Tal placement core (``paikin_tal.cc`` in
``solver.py``)."""
