"""Policy interface + interactive keyboard policy (counterpart of
``mpe_tpu/policy.py``, the same code over the port's env and spaces).

Re-designs reference multiagent/policy.py (``Policy.action`` abstract at
policy.py:5-9; ``InteractivePolicy`` hooking pyglet window key events at
policy.py:13-40). Key input comes from a pluggable ``KeySource``: real
window key events when the env's viewer opened a display window
(render/window.py — the reference's behavior), a raw-mode stdin reader
on a TTY, or a scripted/random source headless. The emitted action
matches the reference exactly: a
5-element move vector (one-hot-ish; u[1]=+x, u[2]=-x, u[3]=+y, u[4]=-y
per policy.py:24-38) concatenated with a zero comm vector for non-silent
agents (movement-only, no comm input — policy.py:12-13).
"""

from __future__ import annotations

import sys

import numpy as np


class Policy:
    """Abstract policy (reference policy.py:5-9)."""

    def action(self, obs):
        raise NotImplementedError


class RandomPolicy(Policy):
    """Uniform-random reference-format action for one agent, drawn on the
    host from ``numpy.random.default_rng(seed + agent_index)``: with the same
    seed it draws the JAX package's actions."""

    def __init__(self, env, agent_index: int, seed: int = 0):
        self._space = env.action_space[agent_index]
        self._rng = np.random.default_rng(seed + agent_index)

    def action(self, obs):
        from mpe_tpu_torch.envs import spaces

        s = self._space
        if isinstance(s, spaces.Discrete):
            onehot = np.zeros(s.n)
            onehot[self._rng.integers(s.n)] = 1.0
            return onehot
        if isinstance(s, spaces.MultiDiscrete):
            parts = []
            for lo, hi in zip(s.low, s.high):
                onehot = np.zeros(hi - lo + 1)
                onehot[self._rng.integers(hi - lo + 1)] = 1.0
                parts.append(onehot)
            return np.concatenate(parts)
        if isinstance(s, spaces.Box):
            return self._rng.uniform(s.low, s.high, s.shape)
        raise TypeError(f"unsupported space {s!r}")


class KeySource:
    """Pluggable key provider for InteractivePolicy."""

    def pressed(self) -> set[str]:
        raise NotImplementedError


class StdinKeySource(KeySource):
    """Non-blocking single-key reader on a TTY (arrow keys + wasd)."""

    _ARROWS = {"[A": "up", "[B": "down", "[C": "right", "[D": "left"}
    _WASD = {"w": "up", "s": "down", "d": "right", "a": "left"}

    def pressed(self) -> set[str]:
        import select
        import termios
        import tty

        keys: set[str] = set()
        if not sys.stdin.isatty():
            return keys
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1)
                if ch == "\x1b":  # escape sequence (arrow keys)
                    seq = sys.stdin.read(2)
                    if seq in self._ARROWS:
                        keys.add(self._ARROWS[seq])
                elif ch in self._WASD:
                    keys.add(self._WASD[ch])
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return keys


class ScriptedKeySource(KeySource):
    """Deterministic key script (for tests / headless demos)."""

    def __init__(self, script):
        self._script = list(script)
        self._t = 0

    def pressed(self) -> set[str]:
        if self._t < len(self._script):
            keys = self._script[self._t]
            self._t += 1
            return set(keys) if not isinstance(keys, str) else {keys}
        return set()


def _viewer_key_source(env, agent_index: int) -> "KeySource | None":
    """A WindowKeySource over the agent's (or the shared) viewer window,
    if the env has rendered one — else None."""
    viewers = getattr(env, "_viewers", None)
    if not viewers:
        return None
    viewer = viewers[agent_index if agent_index < len(viewers) else 0]
    # peek before touching the opening `.window` property, so deciding
    # to fall back to stdin doesn't strand a window we opened here
    had_window = getattr(viewer, "_window", None) is not None
    window = getattr(viewer, "window", None)
    if window is None:
        return None
    import os

    # a non-interactive backend (Agg etc.) never delivers key events —
    # fall back to stdin there, unless MPE_WINDOW=1 explicitly forces
    # the window plumbing (how tests exercise it without a display)
    if (not getattr(window, "interactive", False)
            and os.environ.get("MPE_WINDOW") in (None, "0", "", "false")):
        if not had_window:
            # we opened it and nothing will use it — close and re-arm
            # the viewer's lazy slot (a later human-mode render may
            # still legitimately open one)
            window.close()
            viewer._window = None
            viewer._window_tried = False
        return None
    from mpe_tpu_torch.render.window import WindowKeySource

    return WindowKeySource(window)


class InteractivePolicy(Policy):
    """Keyboard-driven policy (reference policy.py:13-52).

    Emits the reference's interactive action format: with discrete action
    spaces, ``u`` is a 5-vector with u[0]=1 when idle, else the pressed
    direction set to the reference's magnitude (policy.py:24-38), plus a
    zero comm block for non-silent agents.
    """

    def __init__(self, env, agent_index: int, key_source: KeySource | None = None):
        self.env = env
        self.agent_index = agent_index
        if key_source is None:
            # prefer genuine window key events when the env has a live
            # viewer window (the reference hooks the agent's viewer
            # window, policy.py:21-22); fall back to raw-mode stdin
            key_source = _viewer_key_source(env, agent_index)
        self.keys = key_source if key_source is not None else StdinKeySource()
        spec = env.world_spec
        self._movable = bool(spec.movable[agent_index])
        self._silent = bool(spec.silent[agent_index])
        self._dim_c = spec.dim_c

    def action(self, obs):
        pressed = self.keys.pressed()
        discrete_input = getattr(self.env, "discrete_action_input", False)
        if self._movable:
            if discrete_input:
                # integer convention of policy.py:26-31
                u = 0
                if "left" in pressed:
                    u = 1
                if "right" in pressed:
                    u = 2
                if "up" in pressed:
                    u = 4
                if "down" in pressed:
                    u = 3
                move = np.array([u], np.int64)
            else:
                # one-hot convention of policy.py:32-39 (note up->u[4],
                # down->u[3] — the reference's swapped y mapping)
                u = np.zeros(5)
                if "left" in pressed:
                    u[1] += 1.0
                if "right" in pressed:
                    u[2] += 1.0
                if "down" in pressed:
                    u[3] += 1.0
                if "up" in pressed:
                    u[4] += 1.0
                if u[1:].sum() == 0:
                    u[0] += 1.0
                move = u
        else:
            move = np.zeros(0)
        comm = np.zeros(0) if self._silent else np.zeros(self._dim_c)
        return np.concatenate([move, comm])
