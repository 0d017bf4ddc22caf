"""The port's rendering layer (``mpe_tpu_torch.render``, ``MultiAgentEnv.render``)
against the JAX package's, on the CPU.

The rasterizer is numpy in float64 on both sides, so frames are held equal
pixel for pixel: the same geoms drawn by both rasterizers, the golden frame
of ``tests/golden/spread_frame.png``, and every scenario's shared and
per-agent frames. The two packages' random streams differ, so a frame
parity test hands JAX's state to the port (``convert.state_from_numpy``;
the port's wrapper holds a batch of one env) instead of resetting both with
one seed.
"""

import numpy as np
import pytest
import torch

import mpe_tpu.render as j_render
import mpe_tpu.render.raster as j_raster
import mpe_tpu_torch.render as t_render
import mpe_tpu_torch.render.raster as t_raster
from mpe_tpu import make_env as j_make_env
from mpe_tpu.policy import RandomPolicy as JRandomPolicy
from mpe_tpu_torch import make_env
from mpe_tpu_torch.convert import state_from_numpy
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["simple", "simple_adversary", "simple_crypto", "simple_push", "simple_reference",
         "simple_speaker_listener", "simple_spread", "simple_tag", "simple_world_comm"]
COMM = ["simple_crypto", "simple_reference", "simple_speaker_listener", "simple_world_comm"]
GOLDEN = "tests/golden/spread_frame.png"


@pytest.fixture(autouse=True)
def _headless(monkeypatch):
    """No window in any of these tests, whatever the machine has."""
    monkeypatch.setenv("MPE_WINDOW", "0")


def _carry(j_state):
    """A JAX single-env WorldState -> the port's batch of one env."""
    return state_from_numpy(*(np.asarray(x)[None] for x in (
        j_state.pos, j_state.vel, j_state.comm, j_state.goal, j_state.t)), device="cpu")


def _port_env(name, j_env, **kw):
    """The port's stateful env holding ``j_env``'s state, in its dtype."""
    env = make_env(name, device="cpu", dtype=getattr(torch, str(np.asarray(j_env.state.pos).dtype)),
                   **kw)
    env.state = _carry(j_env.state)
    return env


# --- the rasterizer on the same geoms ------------------------------------------------------

def _circle(r):
    g = r.make_circle(0.3)
    g.set_color(0.9, 0.2, 0.1, alpha=0.5)
    g.add_attr(r.Transform(translation=(0.1, -0.2)))
    return [g]


def _polygon(r):
    g = r.make_polygon([(-0.6, -0.5), (0.2, 0.7), (0.7, -0.1), (0.1, -0.3)])
    g.set_color(0.2, 0.6, 0.3)
    g.add_attr(r.Transform(rotation=0.4, scale=(1.2, 0.8)))
    return [g, r.make_polygon([(0, 0), (0.5, 0.5), (0.5, 0)], filled=False)]


def _polyline(r):
    g = r.make_polyline([(-0.8, -0.5), (0.0, 0.6), (0.7, -0.4)])
    g.set_linewidth(2.5)
    g.set_color(0.1, 0.1, 0.8)
    return [g, r.make_circle(0.4, filled=False)]


def _lines(r):
    solid = r.Line((-0.9, 0.3), (0.9, -0.2))
    solid.add_attr(r.LineWidth(3.0))
    dashed = r.Line((-0.9, -0.6), (0.8, 0.6))
    dashed.add_attr(r.LineStyle(0x00FF))
    dashed.add_attr(r.LineWidth(2.0))
    dashed.set_color(0.7, 0.0, 0.3)
    pt = r.Point()
    pt.add_attr(r.Transform(translation=(0.5, 0.5)))
    return [solid, dashed, pt]


def _capsule(r):
    cap = r.make_capsule(0.8, 0.2)
    cap.set_color(0.2, 0.2, 0.9)
    cap.add_attr(r.Transform(translation=(-0.4, 0.1), rotation=0.3))
    return [cap]


def _compound(r):
    c0, c1 = r.make_circle(0.2), r.make_polygon([(0, 0), (0.3, 0), (0.3, 0.3)])
    c0.set_color(0.0, 1.0, 0.0)          # stripped by the compound
    c1.add_attr(r.Transform(translation=(0.2, 0.1)))
    comp = r.Compound([c0, c1])
    comp.set_color(0.0, 0.0, 1.0, alpha=0.7)
    comp.add_attr(r.Transform(translation=(-0.5, -0.5)))
    return [comp]


def _image(r):
    img = np.zeros((8, 12, 3), np.uint8)
    img[:, :6, 0] = 255
    img[:, 6:, 2] = 200
    return [r.Image(img, 0.6, 0.4).add_attr(r.Transform(translation=(-0.4, 0.3))),
            r.Image(img / 255.0, 0.3, 0.5).add_attr(r.Transform(translation=(0.4, -0.3)))]


CASES = {"circle": _circle, "polygon": _polygon, "polyline": _polyline, "lines": _lines,
         "capsule": _capsule, "compound": _compound, "image": _image}


@pytest.mark.parametrize("case", list(CASES) + ["offcanvas_blit"])
def test_raster_matches_jax(case):
    if case == "offcanvas_blit":
        img = np.random.default_rng(0).random((5, 10, 3))
        frames = []
        for r in (j_raster, t_raster):
            c = r.Canvas(40, 30)
            c.blit([(-3.0, -0.2), (1.0, 0.4)], img)
            c.blit([(0.5, 0.8), (1.6, 1.9)], img)
            frames.append(c.rgb_array())
    else:
        frames = []
        for r in (j_raster, t_raster):
            v = r.Viewer(96, 80)
            v.set_bounds(-1.2, 1.0, -1.0, 1.1)
            for g in CASES[case](r):
                v.add_geom(g)
            v.draw_circle(0.1, color=(1.0, 0.5, 0.0))
            frames.append(v.render(return_rgb_array=True))
    assert (frames[1] < 250).any()
    np.testing.assert_array_equal(frames[1], frames[0])


# --- env frames --------------------------------------------------------------------------

def test_golden_frame_from_jax_state():
    PILImage = pytest.importorskip("PIL.Image")
    j_env = j_make_env("simple_spread", seed=0)
    j_env.reset()
    env = _port_env("simple_spread", j_env)
    frames = env.render("rgb_array")
    assert len(frames) == 1 and frames[0].dtype == np.uint8
    golden = np.asarray(PILImage.open(GOLDEN))
    assert frames[0].shape == golden.shape == (700, 700, 3)
    np.testing.assert_array_equal(frames[0], golden)
    # alpha compositing invariant: agent centre = 0.5 colour + 0.5 white
    pos = env.state.pos[0].numpy()
    cx, cy = int((pos[0, 0] + 1.0) / 2.0 * 700), int((1.0 - pos[0, 1]) / 2.0 * 700)
    expect = 0.5 * np.array([0.35, 0.35, 0.85]) * 255 + 0.5 * 255
    assert np.abs(frames[0][cy, cx] - expect).max() <= 1.0


@pytest.mark.parametrize("name", NAMES)
def test_frames_match_jax(name):
    j_env = j_make_env(name, seed=0)
    obs_n = j_env.reset()
    pols = [JRandomPolicy(j_env, i, seed=5) for i in range(j_env.n)]
    for _ in range(2):
        obs_n, *_ = j_env.step([p.action(obs_n[i]) for i, p in enumerate(pols)])
    j_per = j_make_env(name, seed=0, shared_viewer=False)
    j_per.state = j_env.state
    for shared, j_e in ((True, j_env), (False, j_per)):
        env = _port_env(name, j_e, shared_viewer=shared)
        got, want = env.render("rgb_array"), j_e.render("rgb_array")
        assert len(got) == len(want) == (1 if shared else j_env.n)
        for g, w in zip(got, want):
            assert g.shape == (700, 700, 3) and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        env.close()
        assert env._viewers == [None] * len(got)


def test_comm_transcript_matches_jax(capsys):
    rng = np.random.default_rng(0)
    for name in COMM:
        j_env = j_make_env(name, seed=0)
        spec = j_env.world_spec
        comm = rng.random((spec.n_agents, spec.dim_c))
        comm[0] = 0.0                                 # an all-zero utterance prints '_'
        got = t_render.comm_transcript(make_env(name, device="cpu").world_spec, comm)
        assert got == j_render.comm_transcript(spec, comm), name
    # human mode on a headless machine prints the transcript and opens no window
    j_env = j_make_env("simple_reference", seed=0)
    j_env.reset()
    env = _port_env("simple_reference", j_env)
    assert env.render("human") == [True]
    assert env._viewers[0]._window is None
    want = j_render.comm_transcript(j_env.world_spec, np.asarray(j_env.state.comm))
    assert capsys.readouterr().out == want + "\n"


def test_reset_drops_geoms_and_colours_follow_the_new_goal():
    env = make_env("simple_speaker_listener", seed=0, device="cpu")
    env.reset()
    env.render("rgb_array")
    assert env._render_geoms is not None
    goals = set()
    for _ in range(8):
        env.reset()   # the reference's _reset_render (env.py:195-197)
        assert env._render_geoms is None and env._render_xforms is None
        env.render("rgb_array")
        colors = env.scenario.entity_colors(env.state)[0].numpy()
        drawn = np.array([g._color.vec4[:3] for g in env._render_geoms])
        np.testing.assert_array_equal(drawn, colors[:, :3])
        goals.add(int(env.state.goal[0, 0]))
    assert len(goals) > 1, "eight resets drew one goal: the colours were not exercised"
