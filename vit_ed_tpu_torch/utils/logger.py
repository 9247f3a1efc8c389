"""Per-process logger (reference misc/logger.py:15-41 semantics).

Rank 0 logs to the console in color (if a tty); every process appends to
``log_rank{r}{affix}.txt`` in the output directory. A logger is keyed by
its name: creating it again (another trainer of the same model name in one
process, another output directory) replaces its handlers, so a line is
never written twice.
"""

import logging
import os
import sys

_COLORS = {"green": "\033[32m", "yellow": "\033[33m", "reset": "\033[0m"}


def create_logger(output_dir, dist_rank=0, name="", affix=""):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"
    color_fmt = (
        f"{_COLORS['green']}[%(asctime)s %(name)s]{_COLORS['reset']}"
        f"{_COLORS['yellow']}(%(filename)s %(lineno)d){_COLORS['reset']}"
        ": %(levelname)s %(message)s"
    )

    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        use_color = hasattr(sys.stdout, "isatty") and sys.stdout.isatty()
        console.setFormatter(
            logging.Formatter(fmt=color_fmt if use_color else fmt, datefmt="%Y-%m-%d %H:%M:%S")
        )
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log_rank{dist_rank}{affix}.txt"), mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)

    return logger
