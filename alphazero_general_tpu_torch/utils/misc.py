"""Small utilities — the port of alphazero_general_tpu/utils/misc.py:
temperature schedules, checkpoint file names, a progress bar (reference:
alphazero/utils.py:15-54, the vendored progress Bar)."""

from __future__ import annotations

import sys
import time

#: default_temp_scaling (reference: alphazero/utils.py:19-27): the
#: temperature halves every TEMP_SCALE_FACTOR * max_turns turns, down to
#: TEMP_MIN.
TEMP_SCALE_FACTOR = 0.15
TEMP_MIN = 0.2


def get_iter_file(iteration: int) -> str:
    """Checkpoint file name for an iteration (reference: utils.py:15-16)."""
    return f"iteration-{iteration:04d}"


def scale_temp(scale_factor: float, min_temp: float, cur_temp: float,
               turns: int, const_max_turns: int) -> float:
    """Halve the temperature every ``scale_factor * max_turns`` turns with a
    floor of ``min_temp`` (reference: utils.py:19-27)."""
    period = int(scale_factor * const_max_turns) if const_max_turns else 0
    if period and (turns + 1) % period == 0:
        return max(min_temp, cur_temp / 2)
    return cur_temp


def default_temp_scaling(cur_temp: float, turns: int,
                         max_turns: int) -> float:
    """The reference's schedule. Self-play computes it on tensors
    (selfplay._update_temps)."""
    return scale_temp(TEMP_SCALE_FACTOR, TEMP_MIN, cur_temp, turns, max_turns)


def const_temp_scaling(temp: float, *args, **kwargs) -> float:
    """A constant temperature (``SelfPlayConfig.const_temp``)."""
    return temp


class Bar:
    """Progress bar with an ETA (``Bar(msg, max=N)``, ``.suffix``,
    ``.next()``, ``.goto()``, ``.finish()``). It redraws in place on a TTY
    and prints one summary line at ``finish`` otherwise."""

    WIDTH = 24

    def __init__(self, message: str = "", max: int = 100):  # noqa: A002
        self.message = message
        self.max = int(max) or 1
        self.index = 0
        self.suffix = ""
        self._start = time.perf_counter()
        self._stream = sys.stderr
        self._tty = hasattr(self._stream, "isatty") and self._stream.isatty()
        self._last_draw = 0.0

    def _eta(self) -> str:
        if self.index <= 0:
            return "--:--"
        elapsed = time.perf_counter() - self._start
        remain = elapsed / self.index * (self.max - self.index)
        m, s = divmod(int(remain), 60)
        h, m = divmod(m, 60)
        return f"{h:d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"

    def _draw(self, force: bool = False) -> None:
        if not self._tty:
            return
        now = time.perf_counter()
        if not force and now - self._last_draw < 0.1:
            return
        self._last_draw = now
        fill = int(self.WIDTH * min(self.index / self.max, 1.0))
        bar = "#" * fill + "-" * (self.WIDTH - fill)
        line = (f"\r{self.message} |{bar}| {self.index}/{self.max} "
                f"eta {self._eta()} {self.suffix}")
        self._stream.write(line[:119] + "\x1b[K")
        self._stream.flush()

    def next(self, n: int = 1) -> None:
        self.index += n
        self._draw()

    def goto(self, index: int) -> None:
        self.index = int(index)
        self._draw()

    def finish(self) -> None:
        self._draw(force=True)
        if self._tty:
            self._stream.write("\n")
        else:
            elapsed = time.perf_counter() - self._start
            self._stream.write(f"{self.message} {self.index}/{self.max} in "
                               f"{elapsed:.1f}s {self.suffix}\n")
        self._stream.flush()
