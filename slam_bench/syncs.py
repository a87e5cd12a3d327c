"""Host synchronisations counted over the measured window, by the innermost
source line of the port on the Python stack at the call.

A frozen copy of ``mast3r_slam_torch/profile_step.count_syncs``, split into
`start` and `stop` so that it can be armed at the window's first frame and
disarmed at its close, from inside the run it counts: CUDA's sync debug mode
warns at each synchronising call, and the warning is recorded, not shown.
"""

from __future__ import annotations

import os
import traceback
import warnings


class SyncCounter:
    def __init__(self, package_dir: str):
        self.package_dir = package_dir
        self.sites: dict[str, int] = {}
        self._saved = None

    @property
    def total(self) -> int:
        return sum(self.sites.values())

    def _record(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(self.package_dir)]
        site = (f"{os.path.relpath(ours[-1].filename, self.package_dir)}:{ours[-1].lineno}"
                if ours else f"{filename}:{lineno}")
        self.sites[site] = self.sites.get(site, 0) + 1

    def start(self) -> None:
        import torch

        self._saved = (warnings.showwarning, list(warnings.filters))
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = self._record  # after the switch, which warns once itself

    def stop(self) -> None:
        import torch

        if self._saved is None:
            return
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning, filters = self._saved
        warnings.filters[:] = filters
        self._saved = None
