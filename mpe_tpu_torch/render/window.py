"""Optional live-window display backend (import-guarded; counterpart of
``mpe_tpu/render/window.py``, the same code).

The reference opens real pyglet GL windows and hooks *window* key-press
handlers for interactive play (reference multiagent/rendering.py:46-64,
policy.py:21-22). This machine is headless, so the default rendering
path stays the pure-NumPy rasterizer (render/raster.py) — but when a
display exists (or ``MPE_WINDOW=1`` forces it), ``Viewer`` opens a
matplotlib window, blits each rendered frame into it, and exposes a
``WindowKeySource`` fed by genuine key press/release events, which
``InteractivePolicy`` picks up automatically (mpe_tpu_torch/policy.py).

Env var ``MPE_WINDOW``: "1" forces a window (even on a non-interactive
matplotlib backend — used by tests to exercise the event plumbing
without a display), "0" forces headless, unset = auto (window iff a
display is available).
"""

from __future__ import annotations

import os
import sys


def available() -> bool:
    """A real display this process could open a window on."""
    if sys.platform.startswith(("win", "darwin")):
        return True
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


def should_open() -> bool:
    forced = os.environ.get("MPE_WINDOW")
    if forced is not None:
        return forced not in ("0", "", "false")
    return available()


# matplotlib key names -> the KeySource vocabulary of mpe_tpu_torch.policy
_KEYMAP = {"left": "left", "right": "right", "up": "up", "down": "down",
           "a": "left", "d": "right", "w": "up", "s": "down"}


class MplWindow:
    """A matplotlib figure acting as the live display + key-event hub.

    Mirrors the two reference window roles: frame presentation
    (rendering.py:86-112 flip) and key handler registration
    (policy.py:21-22 on_key_press/on_key_release) — here as a held-key
    set maintained from matplotlib's key_press/key_release events.
    """

    def __init__(self, width: int = 700, height: int = 700,
                 title: str = "mpe-tpu"):
        import matplotlib
        import matplotlib.pyplot as plt

        self._plt = plt
        backend = matplotlib.get_backend().lower()
        self.interactive = not any(
            backend.startswith(b) for b in ("agg", "pdf", "svg", "ps",
                                            "cairo", "template"))
        self.fig = plt.figure(figsize=(width / 100, height / 100),
                              dpi=100)
        try:
            self.fig.canvas.manager.set_window_title(title)
        except Exception:
            pass
        self.ax = self.fig.add_axes([0, 0, 1, 1])
        self.ax.axis("off")
        self._im = None
        self.held_keys: set[str] = set()
        self.fig.canvas.mpl_connect("key_press_event", self._on_press)
        self.fig.canvas.mpl_connect("key_release_event", self._on_release)
        self.fig.canvas.mpl_connect("close_event", self._on_close)
        self.isopen = True
        if self.interactive:
            plt.ion()
            self.fig.show()

    # --- key events ---
    def _on_press(self, event):
        k = _KEYMAP.get((event.key or "").lower())
        if k:
            self.held_keys.add(k)

    def _on_release(self, event):
        k = _KEYMAP.get((event.key or "").lower())
        if k:
            self.held_keys.discard(k)

    def _on_close(self, event):
        self.isopen = False

    # --- display ---
    def imshow(self, arr):
        if self._im is None:
            self._im = self.ax.imshow(arr)
        else:
            self._im.set_data(arr)
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        else:
            self.fig.canvas.draw()

    def close(self):
        self.isopen = False
        self._plt.close(self.fig)


class WindowKeySource:
    """KeySource over a window's held-key set (duck-typed against
    mpe_tpu_torch.policy.KeySource to avoid a render->policy import cycle)."""

    def __init__(self, window: MplWindow):
        self._window = window

    def pressed(self) -> set[str]:
        if getattr(self._window, "interactive", False):
            # pump the GUI event loop so key events arrive between steps
            self._window.fig.canvas.flush_events()
        return set(self._window.held_keys)


def open_window(width: int, height: int):
    """An ``MplWindow`` if a window should and can be opened, else None."""
    if not should_open():
        return None
    try:
        return MplWindow(width, height)
    except Exception:
        return None
