"""Rendering layer: headless rasterizer + env-level frame assembly
(counterpart of ``mpe_tpu/render/__init__.py``).

``render_env`` replicates the reference's ``MultiAgentEnv.render``
(reference multiagent/environment.py:200-263): the human-mode comm
transcript print (environment.py:201-213), lazy per-slot viewer creation
(:215-221), one circle geom per entity with agents drawn at alpha 0.5
(:224-245), per-viewer camera bounds of ±1 around the origin (shared
viewer) or around agent *i* (:247-256), and per-entity transform updates
before the draw (:257-261). Everything runs host-side on numpy. The port's
``MultiAgentEnv`` keeps a batch of one env, env axis first, so a frame reads
env 0 of the state, and copies what it draws to the host once per frame
(the entity colours once per episode, when the geoms are built).
"""

from __future__ import annotations

import numpy as np

from mpe_tpu_torch._device import to_host
from mpe_tpu_torch.render.raster import (  # noqa: F401 (re-exported surface)
    Attr, Canvas, Color, Compound, FilledPolygon, Geom, Image, Line,
    LineStyle, LineWidth, Point, PolyLine, SimpleImageViewer, Transform,
    Viewer, get_display, make_capsule, make_circle, make_polygon,
    make_polyline)

_ALPHABET = "abcdefghijklmnopqrstuvwxyz"


def comm_transcript(spec, comm: np.ndarray) -> str:
    """The human-mode message print (environment.py:201-213): each
    speaking agent's utterance rendered as a letter by argmax, '_' when
    all-zero. ``comm`` is one env's ``[A, C]`` on the host."""
    lines = []
    for i in range(spec.n_agents):
        if spec.silent[i] or spec.dim_c == 0:
            continue
        word = "_" if np.all(comm[i] == 0) else _ALPHABET[int(np.argmax(comm[i]))]
        for j in range(spec.n_agents):
            if j == i:
                continue
            lines.append(f"agent {i} to agent {j}: {word}   ")
    return "".join(lines)


def _build_geoms(env):
    """One circle per entity, agents at alpha 0.5 (environment.py:224-245),
    coloured from the state being drawn (the colours of several scenarios
    follow ``state.goal``)."""
    spec = env.world_spec
    colors = to_host(env.scenario.entity_colors(env.state)[0])
    geoms, xforms = [], []
    for e in range(spec.n_entities):
        geom = make_circle(float(spec.size[e]))
        xform = Transform()
        if e < spec.n_agents:
            geom.set_color(*colors[e][:3], alpha=0.5)
        else:
            geom.set_color(*colors[e][:3])
        geom.add_attr(xform)
        geoms.append(geom)
        xforms.append(xform)
    return geoms, xforms


def render_env(env, mode: str = "human"):
    """Render every viewer slot of a stateful ``MultiAgentEnv`` wrapper.

    Returns a list with one entry per viewer (rgb uint8 arrays for
    ``mode='rgb_array'``, else viewer-open booleans), matching the
    reference's list-of-results shape (environment.py:214, 261-263).
    """
    spec = env.world_spec
    state = env.state
    if mode == "human" and spec.dim_c > 0:
        msg = comm_transcript(spec, to_host(state.comm[0]))
        if msg:
            print(msg)

    for v in range(len(env._viewers)):
        if env._viewers[v] is None:
            env._viewers[v] = Viewer(700, 700)

    if env._render_geoms is None:
        env._render_geoms, env._render_xforms = _build_geoms(env)
        for viewer in env._viewers:
            viewer.geoms = list(env._render_geoms)

    pos = to_host(state.pos[0])
    results = []
    cam_range = 1.0
    for v, viewer in enumerate(env._viewers):
        center = np.zeros(2) if env.shared_viewer else pos[v]
        viewer.set_bounds(
            center[0] - cam_range, center[0] + cam_range,
            center[1] - cam_range, center[1] + cam_range)
        for e in range(spec.n_entities):
            env._render_xforms[e].set_translation(*pos[e, :2])
        results.append(viewer.render(return_rgb_array=(mode == "rgb_array")))
    return results


def reset_render(env):
    """Drop cached geoms (environment.py:195-197)."""
    env._render_geoms = None
    env._render_xforms = None


__all__ = [
    "Viewer", "Transform", "Geom", "FilledPolygon", "PolyLine", "Line",
    "Point", "Compound", "LineStyle", "LineWidth", "Image",
    "SimpleImageViewer", "get_display", "make_circle", "make_polygon",
    "make_polyline", "make_capsule", "render_env", "reset_render",
    "comm_transcript",
]
