"""Live-updating terminal table of the config parameters actually read.

A copy of `nanowakeword_tpu/utils/dynamic_table.py` (stdlib only), driven
by ConfigProxy access tracking; re-renders in place (ANSI cursor-up) as more
keys are touched, excluding noisy path-like keys.
"""

from __future__ import annotations

import sys

EXCLUDED_SUBSTRINGS = ("path", "dir", "manifest", "output_filename")


class DynamicTable:
    def __init__(self, config_proxy, title: str = "Configuration",
                 enabled: bool = True):
        self.config_proxy = config_proxy
        self.title = title
        self.enabled = enabled
        self._last_height = 0

    def _rows(self):
        rows = []
        for key, value in sorted(self.config_proxy.report().items()):
            if any(s in key.lower() for s in EXCLUDED_SUBSTRINGS):
                continue
            sval = str(value)
            if len(sval) > 48:
                sval = sval[:45] + "..."
            rows.append((key, sval))
        return rows

    def update(self, force_print: bool = False):
        if not self.enabled:
            return
        rows = self._rows()
        if not rows and not force_print:
            return
        if self._last_height and sys.stdout.isatty():
            sys.stdout.write(f"\x1b[{self._last_height}F\x1b[J")
        width = max((len(k) for k, _ in rows), default=20)
        lines = [f"--- {self.title} ---"]
        lines += [f"  {k:<{width}}  {v}" for k, v in rows]
        out = "\n".join(lines)
        print(out)
        self._last_height = out.count("\n") + 1
