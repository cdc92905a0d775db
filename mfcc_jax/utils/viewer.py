"""Live scrolling feature viewer: the recv.c role, on the host.

The reference ships an SDL window that scrolls incoming cepstral columns as
an inferno-colored spectrogram, one row per frame, while the stream runs
(software/recv.c:20-76,101-155), with the VAD power check in
the same host family (cepstrum.c:161-183).

Here the renderer is output-agnostic so it works over SSH and in tests:

  * ``TerminalScroller`` -- ANSI 24-bit half-block rendering to any stream
    (two frames per text row via the upper-half-block glyph), cursor-homed
    in-place redraws, a VAD VOICE/silence status line, and the reference's
    exact contrast mapping ((val + 3000) * 4 / 65535 into inferno,
    recv.c:54-58).
  * ``MatplotlibScroller`` -- a FuncAnimation window when a display exists
    (the SDL-window equivalent).

``follow_frames`` turns any byte source (socket, pipe, file being appended)
into an iterator of decoded feature columns using the resynchronizing frame
decoder, so byte loss mid-stream is tolerated exactly like serial.c.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..io import transport
from .vad import voice_activity_power, DEFAULT_THRESHOLD


def _inferno_lut(n: int = 256) -> np.ndarray:
    """(n, 3) uint8 inferno LUT (tinycolormap.hpp's table is matplotlib's)."""
    import matplotlib
    cmap = matplotlib.colormaps["inferno"]
    return (np.asarray(cmap(np.linspace(0, 1, n)))[:, :3] * 255).astype(
        np.uint8)


def columns_to_rgb(cols: np.ndarray, lut: np.ndarray | None = None
                   ) -> np.ndarray:
    """(F, ncep) int16 -> (F, ncep, 3) uint8 with the reference's contrast
    mapping: scale = (val + 3000) * 4, x = scale / 65535 (recv.c:54-58)."""
    if lut is None:
        lut = _inferno_lut()
    scale = (cols.astype(np.int32) + 3000) * 4
    x = np.clip(scale, 0, 65535) * (len(lut) - 1) // 65535
    return lut[x]


def follow_frames(read, ncep: int, *, poll_s: float = 0.02,
                  idle_timeout: float | None = None):
    """Yield (F, ncep) int16 column batches from a byte source.

    ``read()`` returns the next chunk of bytes, b"" when the source is
    (currently) exhausted, or None to signal end-of-stream.  Resynchronizes
    on the 0xa55a magic after any byte loss; stops after ``idle_timeout``
    seconds without data (None = wait forever)."""
    buf = b""
    last_data = time.time()
    while True:
        data = read()
        if data is None:
            break
        if data:
            last_data = time.time()
            buf += data
            cols, consumed = transport.decode_frames(buf, ncep)
            buf = buf[consumed:]
            if len(cols):
                yield cols
        else:
            if idle_timeout is not None \
                    and time.time() - last_data > idle_timeout:
                break
            time.sleep(poll_s)


class TerminalScroller:
    """Scrolling inferno spectrogram on a character terminal.

    Each text row shows two frames (time scrolls upward like recv.c's
    memmove) using the upper-half-block glyph with separate fg/bg 24-bit
    colors; newest frame at the bottom."""

    def __init__(self, ncep: int, height: int = 24, out=None,
                 vad_window: int = 93, threshold: int = DEFAULT_THRESHOLD):
        self.ncep = ncep
        self.height = height                      # text rows => 2x frames
        self.out = out if out is not None else sys.stdout
        self.lut = _inferno_lut()
        self.ring = np.zeros((2 * height, ncep), np.int16)
        self.recent: list[np.ndarray] = []        # VAD window of columns
        self.vad_window = vad_window
        self.threshold = threshold
        self.n_frames = 0
        self._started = False

    def push(self, cols: np.ndarray) -> None:
        cols = np.asarray(cols, np.int16)
        F = len(cols)
        if F == 0:
            return
        keep = min(F, len(self.ring))
        self.ring = np.roll(self.ring, -keep, axis=0)
        self.ring[-keep:] = cols[-keep:]
        self.n_frames += F
        self.recent.extend(cols)
        self.recent = self.recent[-self.vad_window:]
        self.render()

    def vad_power(self) -> int:
        if not self.recent:
            return 0
        return int(voice_activity_power(np.stack(self.recent)))

    def render(self) -> None:
        w = self.out
        rgb = columns_to_rgb(self.ring, self.lut)    # (2H, ncep, 3)
        if not self._started:
            w.write("\x1b[2J")                       # clear once
            self._started = True
        w.write("\x1b[H")                            # cursor home
        for r in range(self.height):
            top, bot = rgb[2 * r], rgb[2 * r + 1]
            line = []
            for c in range(self.ncep):
                tr, tg, tb = (int(v) for v in top[c])
                br, bg_, bb = (int(v) for v in bot[c])
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg_};{bb}m▀")
            w.write("".join(line) + "\x1b[0m\n")
        p = self.vad_power()
        state = "VOICE  " if p > self.threshold else "silence"
        w.write(f"\x1b[0K{self.n_frames:8d} frames  vad={p:<12d} {state}\n")
        w.flush()

    def close(self) -> None:
        if self._started:
            self.out.write("\x1b[0m\n")
            self.out.flush()


class MatplotlibScroller:
    """FuncAnimation window (the SDL equivalent) -- requires a display."""

    def __init__(self, ncep: int, n_frames: int = 465,
                 threshold: int = DEFAULT_THRESHOLD):
        import matplotlib.pyplot as plt
        self.ncep = ncep
        self.buf = np.zeros((n_frames, ncep), np.int16)
        self.threshold = threshold
        self.fig, self.ax = plt.subplots(figsize=(4, 8))
        self.im = self.ax.imshow(
            columns_to_rgb(self.buf), aspect="auto", origin="lower",
            interpolation="nearest")
        self.ax.set_xlabel("cepstrum")
        self.ax.set_ylabel("frame")
        self.title = self.ax.set_title("waiting...")
        self._plt = plt

    def push(self, cols: np.ndarray) -> None:
        cols = np.asarray(cols, np.int16)
        keep = min(len(cols), len(self.buf))
        if keep:
            self.buf = np.roll(self.buf, -keep, axis=0)
            self.buf[-keep:] = cols[-keep:]

    def run(self, frame_iter, interval_ms: int = 50) -> None:
        from matplotlib.animation import FuncAnimation

        def update(_):
            try:
                self.push(next(frame_iter))
            except StopIteration:
                pass
            self.im.set_data(columns_to_rgb(self.buf))
            p = int(voice_activity_power(self.buf[-93:]))
            self.title.set_text(
                "VOICE" if p > self.threshold else "silence")
            return [self.im, self.title]

        self._anim = FuncAnimation(self.fig, update, interval=interval_ms,
                                   cache_frame_data=False)
        self._plt.show()


def open_source(src: str, timeout: float = 30.0):
    """'-' = stdin, 'host:port' = TCP connect, else a file to follow.
    Returns (read, close): read() -> bytes | b"" (idle) | None (EOF)."""
    if src == "-":
        import os
        fd = sys.stdin.buffer.fileno()
        os.set_blocking(fd, False)

        def read_stdin():
            import os as _os
            try:
                data = _os.read(fd, 65536)
                return data if data else None     # b"" from os.read = EOF
            except BlockingIOError:
                return b""
        return read_stdin, lambda: None

    if ":" in src and not src.endswith(".mfcc") and "/" not in src:
        import socket
        host, port = src.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.settimeout(0.05)

        def read_sock():
            try:
                data = sock.recv(65536)
                return data if data else None
            except TimeoutError:
                return b""
            except OSError:
                return None
        return read_sock, sock.close

    f = open(src, "rb")                           # follow a growing file

    def read_file():
        return f.read(65536) or b""               # b"" keeps following
    return read_file, f.close
