"""Process-title progress display, dependency-free (the JAX package's
``dctseg/utils/proctitle.py``).

The reference announces driver progress in ``ps`` via setproctitle
(train.py:120 'Training!', test*.py:146 'Testing!').  On Linux the same
capability is ``/proc/self/comm`` (the kernel's task name, 15 characters),
which ps, top and htop show.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("dctseg_torch")

_COMM_MAX = 15  # TASK_COMM_LEN - 1


def set_process_title(title: str) -> bool:
    """Best effort: set the kernel task name shown by ps and top.

    Returns True when the title was applied; does nothing where there is no
    writable /proc/self/comm (macOS, a read-only /proc).
    """
    try:
        with open("/proc/self/comm", "w") as f:
            f.write(title[:_COMM_MAX])
        return True
    except OSError:
        logger.debug("process title unsupported on this platform")
        return False
