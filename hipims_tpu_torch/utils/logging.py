"""Timestamped console + file logging.

Replaces CLog (reference: src/General/CLog.cpp:30-120): timestamped lines,
titled blocks, mirrored to a log file when configured.  ANSI colour instead
of ncurses.
"""

from __future__ import annotations

import datetime
import sys


class Logger:
    def __init__(self, path=None, quiet=False, color=None):
        self.quiet = quiet
        self.file = open(path, "a") if path else None
        self.color = (sys.stdout.isatty() if color is None else color)

    def _stamp(self):
        return datetime.datetime.now().strftime("%H:%M:%S")

    def line(self, msg="", error=False):
        text = f"[{self._stamp()}] {msg}"
        if self.file:
            self.file.write(text + "\n")
            self.file.flush()
        if not self.quiet or error:
            stream = sys.stderr if error else sys.stdout
            if error and self.color:
                text = f"\033[91m{text}\033[0m"
            print(text, file=stream, flush=True)

    def block(self, title):
        bar = "-" * 60
        self._last_block = title
        self._block_shown = not self.quiet
        if self.color and not self.quiet:
            print(f"\033[96m{bar}\n {title}\n{bar}\033[0m", flush=True)
        elif not self.quiet:
            print(f"{bar}\n {title}\n{bar}", flush=True)
        if self.file:
            self.file.write(f"{bar}\n {title}\n{bar}\n")

    def error(self, msg):
        # Quiet runs suppress block titles; an error without its phase
        # context is harder to place, so surface the title on stderr once.
        if not getattr(self, "_block_shown", True) and \
                getattr(self, "_last_block", None):
            self.line(f"(during: {self._last_block})", error=True)
            self._block_shown = True
        self.line(f"ERROR: {msg}", error=True)
