"""Screen+file logger (behavioral reference: PCONV_operator/Logger.py)."""

from __future__ import annotations


class Logger:
    def __init__(self, fname: str | None = None, screen: bool = True,
                 file: bool = True):
        self.screen = screen
        self.fout = open(fname, "w") if (file and fname) else None

    def log(self, msg: str) -> None:
        if self.screen:
            print(msg, flush=True)
        if self.fout:
            self.fout.write(msg + "\n")
            self.fout.flush()

    def close(self) -> None:
        if self.fout:
            self.fout.close()
            self.fout = None
