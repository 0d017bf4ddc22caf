"""The port's policies (``mpe_tpu_torch.policy``), window key source,
video export and interactive CLI against the JAX package's, on the CPU.

``RandomPolicy`` draws on the host from ``numpy.random.default_rng(seed +
agent_index)`` in both packages, so the actions are held equal exactly;
``InteractivePolicy`` is held equal under one key script in the one-hot and
the integer action forms (reference policy.py:24-38).
"""

import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

from mpe_tpu import make_env as j_make_env
from mpe_tpu.core.actions import ActionMode as JMode
from mpe_tpu.policy import InteractivePolicy as JInteractivePolicy
from mpe_tpu.policy import RandomPolicy as JRandomPolicy
from mpe_tpu.policy import ScriptedKeySource as JScriptedKeySource
from mpe_tpu_torch import ActionMode, make_env
from mpe_tpu_torch.policy import InteractivePolicy, RandomPolicy, ScriptedKeySource
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
NAMES = ["simple", "simple_adversary", "simple_crypto", "simple_push", "simple_reference",
         "simple_speaker_listener", "simple_spread", "simple_tag", "simple_world_comm"]
SCRIPT = ["right", "up", [], ["left", "down"], "down", ["left"], ["up", "right"]]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_random_policy_matches_jax(name, mode):
    kw = {"action_mode": ActionMode.CONTINUOUS} if mode == "continuous" else {}
    j_kw = {"action_mode": JMode.CONTINUOUS} if mode == "continuous" else {}
    env = make_env(name, device="cpu", **kw)
    j_env = j_make_env(name, **j_kw)
    for i in range(env.n):
        pol, j_pol = RandomPolicy(env, i, seed=7), JRandomPolicy(j_env, i, seed=7)
        try:
            j_pol.action(None)
        except TypeError:
            # a Tuple space (continuous move + comm): neither package draws for it
            with pytest.raises(TypeError, match="unsupported space"):
                pol.action(None)
            return
        j_pol = JRandomPolicy(j_env, i, seed=7)
        for _ in range(3):
            a, b = pol.action(None), j_pol.action(None)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # and they step the port's env
    obs_n = env.reset()
    pols = [RandomPolicy(env, i, seed=3) for i in range(env.n)]
    obs_n, rew_n, _, _ = env.step([p.action(obs_n[i]) for i, p in enumerate(pols)])
    assert np.isfinite(rew_n).all()


@pytest.mark.parametrize("name", ["simple", "simple_speaker_listener", "simple_world_comm"])
@pytest.mark.parametrize("integer", [False, True])
def test_interactive_policy_matches_jax(name, integer):
    kw = {"action_mode": ActionMode.DISCRETE_INDEX} if integer else {}
    j_kw = {"action_mode": JMode.DISCRETE_INDEX} if integer else {}
    env = make_env(name, device="cpu", **kw)
    j_env = j_make_env(name, **j_kw)
    assert env.discrete_action_input == j_env.discrete_action_input == integer
    obs_n = env.reset()
    for i in range(env.n):
        pol = InteractivePolicy(env, i, ScriptedKeySource(SCRIPT))
        j_pol = JInteractivePolicy(j_env, i, JScriptedKeySource(SCRIPT))
        acts = [pol.action(obs_n[i]) for _ in range(len(SCRIPT) + 1)]
        for a, b in zip(acts, (j_pol.action(None) for _ in acts)):
            np.testing.assert_array_equal(a, b)
    # the reference's one-hot convention: left u[1], right u[2], down u[3], up u[4]
    if name == "simple" and not integer:
        pol = InteractivePolicy(env, 0, ScriptedKeySource(["right", "up", []]))
        for want in ([0, 0, 1, 0, 0], [0, 0, 0, 0, 1], [1, 0, 0, 0, 0]):
            np.testing.assert_array_equal(pol.action(None), want)
    if integer and not all(env.world_spec.silent):
        return   # the keyboard emits no comm index: the integer form steps silent agents only
    pols = [InteractivePolicy(env, i, ScriptedKeySource(SCRIPT)) for i in range(env.n)]
    _, rew_n, _, _ = env.step([p.action(obs_n[i]) for i, p in enumerate(pols)])
    assert np.isfinite(rew_n).all()


def test_window_key_events_drive_interactive_policy(monkeypatch):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg", force=True)
    from matplotlib.backend_bases import KeyEvent

    from mpe_tpu_torch.render.window import WindowKeySource

    monkeypatch.setenv("MPE_WINDOW", "1")
    env = make_env("simple", seed=0, device="cpu")
    env.reset()
    env.render("rgb_array")               # creates the viewer, opens no window
    assert env._viewers[0]._window is None
    window = env._viewers[0].window       # the key-source hook opens it
    assert window is not None
    pol = InteractivePolicy(env, 0)       # discovers the window
    assert isinstance(pol.keys, WindowKeySource)
    assert np.array_equal(pol.action(None), [1, 0, 0, 0, 0])
    for event, key, want in (("key_press_event", "left", [0, 1, 0, 0, 0]),
                             ("key_release_event", "left", [1, 0, 0, 0, 0]),
                             ("key_press_event", "up", [0, 0, 0, 0, 1]),
                             ("key_release_event", "up", [1, 0, 0, 0, 0]),
                             ("key_press_event", "d", [0, 0, 1, 0, 0])):
        KeyEvent(event, window.fig.canvas, key)._process()
        assert np.array_equal(pol.action(None), want), (event, key)
    # a human-mode render blits the frame into the window
    env.render("human")
    frame = env.render("rgb_array")[0]
    assert np.array_equal(np.asarray(window._im.get_array()), frame)
    env.close()
    assert not window.isopen


def test_record_episode_and_gif(tmp_path):
    from mpe_tpu_torch.render.video import record_episode, record_gif, save_gif

    env = make_env("simple_tag", seed=0, device="cpu")
    frames = record_episode(env, n_steps=4)
    assert len(frames) == 4
    assert all(f.shape == (700, 700, 3) and f.dtype == np.uint8 for f in frames)
    assert any((a != b).any() for a, b in zip(frames, frames[1:]))
    with pytest.raises(ValueError, match="no frames"):
        save_gif([], str(tmp_path / "none.gif"))
    PILImage = pytest.importorskip("PIL.Image")
    path = record_gif("simple_tag", str(tmp_path / "tag.gif"), n_steps=3, device="cpu")
    assert os.path.getsize(path) > 1000
    im = PILImage.open(path)
    assert im.n_frames == 3 and im.size == (350, 350)


def test_interactive_cli_headless():
    out = subprocess.run(
        [sys.executable, "-m", "mpe_tpu_torch.interactive_cli", "--scenario", "simple.py",
         "--device", "cpu", "--steps", "2", "--headless"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "MPE_WINDOW": "0"})
    assert out.returncode == 0, out.stderr[-800:]
    lines = out.stdout.splitlines()
    assert [ln.split(" rewards=")[0] for ln in lines] == ["t=0", "t=1"]
    assert all(np.isfinite(float(ln.split("[")[1].rstrip("]"))) for ln in lines)


def test_interactive_cli_saves_frames(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    from mpe_tpu_torch import interactive_cli

    monkeypatch.setenv("MPE_WINDOW", "0")
    interactive_cli.main(["--scenario", "simple_adversary", "--device", "cpu", "--steps", "2",
                          "--headless", "--save-frames", str(tmp_path)])
    # one viewer per agent (shared_viewer=False), one file per viewer and step
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"t{t:05d}_v{v}.png" for t in range(2) for v in range(3)]


def test_console_script_is_declared():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["mpe-interactive-torch"] == "mpe_tpu_torch.interactive_cli:main"
