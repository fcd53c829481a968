"""Wall-clock stage timing + ETA (a copy of ``dasac_tpu/utils/timer.py``;
reference utils/timer.py:9-38)."""

import time


class Timer:
    def __init__(self, label=""):
        self.label = label
        self.start = time.monotonic()
        self.stage_start = self.start
        self.progress = 0.0

    def reset_stage(self):
        self.stage_start = time.monotonic()

    def get_stage_elapsed(self):
        return time.monotonic() - self.stage_start

    def elapsed(self):
        return time.monotonic() - self.start

    def update_progress(self, p):
        self.progress = max(p, 1e-8)

    def est_total(self):
        return self.elapsed() / self.progress

    def est_remaining(self):
        return self.est_total() - self.elapsed()

    def str_est_finish(self):
        eta = time.localtime(time.time() + self.est_remaining())
        return time.strftime("%Y-%m-%d %H:%M:%S", eta)
