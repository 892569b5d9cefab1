"""Interactive bullet menu for the config questionnaire.

Counterpart of ``accelerate_tpu/commands/menu.py`` (the reference's
``commands/menu/`` cursor, input, keymap and selection modules in one):
arrow or j/k navigation with an ANSI redraw on a terminal, and a numbered
prompt wherever stdin is not a terminal (CI, pipes, notebooks).
"""

from __future__ import annotations

import sys

_HIDE, _SHOW = "\x1b[?25l", "\x1b[?25h"
_UP_ONE = "\x1b[1A"
_CLEAR_LINE = "\x1b[2K\r"


def _read_key(stdin) -> str:
    """One keypress, decoding CSI (``ESC [ A``) and SS3 (``ESC O A``) arrow
    sequences (SS3 = application cursor-key mode, common after full-screen
    apps). An empty read is EOF — the pty hung up; raising stops the menu
    from busy-looping on "" with the terminal still in cbreak."""
    ch = stdin.read(1)
    if ch in ("", "\x04"):  # true EOF, or Ctrl-D as a literal byte (cbreak
        raise EOFError("stdin closed while the menu was open")  # disables VEOF)
    if ch == "\x1b":
        follow = stdin.read(1)
        if follow == "":
            raise EOFError("stdin closed while the menu was open")
        if follow in ("[", "O"):
            code = stdin.read(1)
            if code == "":
                raise EOFError("stdin closed while the menu was open")
            return {"A": "up", "B": "down"}.get(code, "")
        # bare Esc followed by a normal key: don't swallow the key
        return follow
    if ch in ("\r", "\n"):
        return "enter"
    if ch == "\x03":  # Ctrl-C
        raise KeyboardInterrupt
    return ch


class BulletMenu:
    """``run()`` returns the selected index.

    TTY: ● bullet, ↑/↓ or j/k to move, digits jump, Enter confirms.
    Non-TTY: numbered list + plain ``input()`` (Enter keeps the default).
    """

    def __init__(self, prompt: str, choices: list[str], default: int = 0):
        self.prompt = prompt
        self.choices = list(choices)
        self.default = default

    # -- plain fallback ------------------------------------------------------

    def _run_plain(self) -> int:
        print(self.prompt)
        for i, choice in enumerate(self.choices):
            marker = "*" if i == self.default else " "
            print(f"  {marker} {i}) {choice}")
        raw = input(f"Choice [{self.default}]: ").strip()
        if not raw:
            return self.default
        try:
            index = int(raw)
        except ValueError:
            matches = [i for i, c in enumerate(self.choices) if c == raw]
            if matches:
                return matches[0]
            raise ValueError(f"{raw!r} is not an option of {self.choices}")
        if not 0 <= index < len(self.choices):
            raise ValueError(f"choice {index} out of range 0..{len(self.choices) - 1}")
        return index

    # -- raw-terminal path ---------------------------------------------------

    def _draw(self, current: int, first: bool) -> None:
        out = sys.stdout
        if not first:
            out.write((_UP_ONE + _CLEAR_LINE) * len(self.choices))
        for i, choice in enumerate(self.choices):
            bullet = "\x1b[36m●\x1b[0m" if i == current else " "
            out.write(f" {bullet} {choice}\n")
        out.flush()

    def _run_tty(self) -> int:
        import termios
        import tty

        print(f"{self.prompt} (↑/↓ + Enter)")
        current = self.default
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        sys.stdout.write(_HIDE)
        try:
            tty.setcbreak(fd)  # cbreak only gates INPUT; drawing is unaffected
            self._draw(current, first=True)
            while True:
                key = _read_key(sys.stdin)
                if key == "enter":
                    return current
                if key in ("up", "k"):
                    current = (current - 1) % len(self.choices)
                elif key in ("down", "j"):
                    current = (current + 1) % len(self.choices)
                elif key.isdigit() and int(key) < len(self.choices):
                    current = int(key)
                else:
                    continue
                self._draw(current, first=False)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
            sys.stdout.write(_SHOW)
            sys.stdout.flush()

    def run(self) -> int:
        if sys.stdin.isatty() and sys.stdout.isatty():
            return self._run_tty()
        return self._run_plain()


def select(prompt: str, choices: list[str], default: str) -> str:
    """Menu over string choices returning the chosen string."""
    menu = BulletMenu(prompt, choices, default=choices.index(default))
    return choices[menu.run()]
