"""Small system helpers (a copy of ``dasac_tpu/utils/sys_tools.py``;
reference utils/sys_tools.py:10-31).

``find_free_port`` picks the TCP port of the rendezvous when the trainer
spawns one process per device (``train/cli.py``).
"""

import os
import socket


def find_free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def check_dir(base, *subdirs):
    path = os.path.join(base, *subdirs) if subdirs else base
    os.makedirs(path, exist_ok=True)
    return path
