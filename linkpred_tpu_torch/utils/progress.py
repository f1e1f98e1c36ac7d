"""Live in-terminal training progress — the port's own copy of
`linkpred_tpu/utils/progress.py`.

On a TTY the line redraws in place:

    twowl-scale  [=========>          ]  96/160  loss 0.294 ▇▅▃▂▂▁▁  val 0.925 ▁▃▅▆▇▇█

On a non-TTY stream (captured or piped output) it degrades to one plain
line per tenth of the run, with no ANSI escapes. The caller closes it when
the run ends.
"""

from __future__ import annotations

import sys

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 16) -> str:
    """Unicode sparkline of the last `width` values (NaNs/sentinels of
    exactly -1.0 are dropped: the epoch loop logs -1 on skipped evals)."""
    vals = [float(v) for v in values if v == v and v != -1.0]
    vals = vals[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _BLOCKS[min(int((v - lo) / span * (len(_BLOCKS) - 1)),
                    len(_BLOCKS) - 1)]
        for v in vals
    )


class LiveProgress:
    """Progress bar + rolling loss/metric sparklines.

    `update(step, loss=..., auc=...)` appends to the series and redraws;
    `close()` finalizes the line. Redraw-in-place only on TTYs; otherwise
    each update prints a standalone line.
    """

    def __init__(self, total: int, label: str = "train", stream=None,
                 bar_width: int = 20):
        self.total = max(int(total), 1)
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.bar_width = bar_width
        self.losses: list[float] = []
        self.aucs: list[float] = []
        self._tty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._last_decile = -1

    def update(self, step: int, loss: float | None = None,
               auc: float | None = None) -> None:
        if loss is not None:
            self.losses.append(float(loss))
        if auc is not None and auc == auc and auc != -1.0:
            self.aucs.append(float(auc))
        frac = min(step / self.total, 1.0)
        if not self._tty:
            # captured/piped logs: one line per 10% (not per update)
            decile = int(frac * 10)
            if decile == self._last_decile and step != self.total:
                return
            self._last_decile = decile
        filled = int(frac * self.bar_width)
        bar = "=" * filled + ">" * (filled < self.bar_width) + " " * (
            self.bar_width - filled - 1)
        parts = [f"{self.label}  [{bar}] {step:>5}/{self.total}"]
        if self.losses:
            parts.append(
                f"loss {self.losses[-1]:.4f} {sparkline(self.losses)}")
        if self.aucs:
            parts.append(f"val {self.aucs[-1]:.4f} {sparkline(self.aucs)}")
        line = "  ".join(parts)
        if self._tty:
            self.stream.write("\r\x1b[2K" + line)
        else:
            self.stream.write(line + "\n")
        self.stream.flush()

    def close(self) -> None:
        if self._tty:
            self.stream.write("\n")
            self.stream.flush()
