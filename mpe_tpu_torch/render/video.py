"""Rollout video export — save episodes as GIF/PNG sequences (counterpart
of ``mpe_tpu/render/video.py``).

The reference can only render live pyglet windows; headless export is a
capability gap this fills: roll out any scenario (random or custom
policy) and write an animated GIF via PIL, which is imported only when a
GIF is written. Rendering stays host-side and off the hot path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from mpe_tpu_torch.envs.wrappers import MultiAgentEnv


def record_episode(
    env: MultiAgentEnv,
    n_steps: int = 50,
    policy: Callable | None = None,
) -> list[np.ndarray]:
    """Roll one episode and return rgb frames (one per step, first
    viewer). ``policy(obs_n) -> action_n`` defaults to random actions."""
    from mpe_tpu_torch.policy import RandomPolicy

    obs_n = env.reset()
    if policy is None:
        pols = [RandomPolicy(env, i) for i in range(env.n)]

        def policy(obs_n):
            return [p.action(obs_n[i]) for i, p in enumerate(pols)]

    frames = []
    for _ in range(n_steps):
        frames.append(env.render("rgb_array")[0])
        obs_n, _, done_n, _ = env.step(policy(obs_n))
        if all(done_n):
            break
    return frames


def save_gif(frames: list[np.ndarray], path: str, fps: int = 15,
             scale: float = 0.5) -> str:
    """Write frames to an animated GIF (PIL); returns the path."""
    from PIL import Image

    if not frames:
        raise ValueError("no frames to save")
    imgs = []
    for f in frames:
        im = Image.fromarray(np.asarray(f))
        if scale != 1.0:
            im = im.resize((int(im.width * scale), int(im.height * scale)))
        imgs.append(im)
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def record_gif(scenario_name: str, path: str, n_steps: int = 50,
               seed: int = 0, **env_kwargs) -> str:
    """One-call demo: ``record_gif('simple_tag', 'tag.gif')``. ``env_kwargs``
    go to ``make_env``: the env runs on the card unless ``device`` names
    another (it raises without one)."""
    from mpe_tpu_torch import make_env

    env = make_env(scenario_name, seed=seed, **env_kwargs)
    return save_gif(record_episode(env, n_steps=n_steps), path)
