"""The port's evolution strategies (``learner/es.py``) against the JAX
package on the CPU, where K4 runs as its plain version.

- a member's score (plain K4) against JAX's ``score`` (K4 in Pallas
  interpret mode) on the same perturbed params, at
  ``tests/test_fused.py::test_es_learns_simple``'s shape (64 envs x 20
  steps, horizon 10, hidden 16), float32: atol and rtol 1e-5, the K4 gate;
- the rank shaping and the update, given JAX's noise and the same scores,
  against JAX's jitted step (its rollout replaced by a score that is a
  fixed linear function of the member's params), float32 at 1e-6;
- the port's mirror of ``test_es_learns_simple``: 30 generations improve
  the mean score of the last five on the first five's by 25%.

The noise comes from a ``torch.Generator`` in the port and from JAX's
keys there, so a whole generation is compared with the noise handed over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpe_tpu.ops.fused_policy as j_fused_policy
from mpe_tpu.learner import init_policy as j_init_policy
from mpe_tpu.learner.es import build_es_step as j_build_es_step
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.learner import es
from mpe_tpu_torch.learner.optim import tree_leaves
from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = dict(n_envs=64, n_steps=20, horizon=10)
POP, SIGMA, LR = 8, 0.1, 0.1


def _params(seed=0):
    k = j_kernel_scenario("simple")
    tree = jax.tree.map(np.asarray, j_init_policy(jax.random.PRNGKey(seed), k.obs_w, 5,
                                                  hidden=16))
    return tree, params_from_numpy(tree, device="cpu")


def _jax_noise(tree, gen, half):
    """JAX's build_es_step draws its noise so (``mpe_tpu/learner/es.py``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), gen)
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    return [np.asarray(jax.random.normal(k, (half,) + x.shape, x.dtype))
            for k, x in zip(keys, leaves)]


def test_member_score_matches_jax_interpret():
    tree, params = _params()
    gen = 3
    noise = _jax_noise(tree, gen, POP // 2)
    j_run = j_fused_policy.fused_policy_rollout(j_kernel_scenario("simple"), tree,
                                                block_envs=64, interpret=True, **SHAPE)
    t_run = fused_policy_rollout(kernel_scenario("simple"), params, block_envs=64, device="cpu",
                                 **SHAPE)
    t_noise = [torch.as_tensor(n) for n in noise]
    got = es._member_scores(t_run.plain, params, t_noise, gen, SIGMA)
    assert got.shape == (POP,) and got.dtype == torch.float32
    leaves, treedef = jax.tree.flatten(tree)
    for member in (0, POP // 2 + 1):
        sign, idx = (1.0, member) if member < POP // 2 else (-1.0, member - POP // 2)
        theta = treedef.unflatten([x + sign * SIGMA * n[idx] for x, n in zip(leaves, noise)])
        ret, _, eps = j_run(gen, theta)
        want = float((ret.sum(0) / jnp.maximum(eps[0], 1.0)).mean())
        np.testing.assert_allclose(float(got[member]), want, rtol=1e-5, atol=1e-5)


def _linear_scores(weights, lib):
    """A rollout stand-in whose score is a fixed linear function of the
    member's params: ``sum(w * x)`` over the leaves in flattening order."""
    def run(gen, theta):
        leaves = jax.tree.leaves(theta) if lib is jnp else tree_leaves(theta)
        s = sum((x * w).sum() for x, w in zip(leaves, weights))
        return lib.ones((1, 4)) * s, None, lib.ones((1, 4))

    return run


def test_rank_shaping_and_update_match_jax(monkeypatch):
    tree, params = _params(1)
    rng = np.random.default_rng(0)
    weights = [rng.normal(size=x.shape).astype(np.float32) for x in jax.tree.leaves(tree)]
    monkeypatch.setattr(j_fused_policy, "fused_policy_rollout",
                        lambda *a, **k: _linear_scores([jnp.asarray(w) for w in weights], jnp))
    j_step = j_build_es_step(j_kernel_scenario("simple"), tree, pop=POP, sigma=SIGMA, lr=LR,
                             **SHAPE)
    gen = 5
    j_new, j_mean = j_step(tree, gen)
    noise = [torch.as_tensor(n) for n in _jax_noise(tree, gen, POP // 2)]
    scores = es._member_scores(_linear_scores([torch.as_tensor(w) for w in weights], torch),
                               params, noise, gen, SIGMA)
    assert len(set(scores.tolist())) == POP          # the ranks are all distinct
    new = es._es_update(params, noise, scores, SIGMA, LR)
    np.testing.assert_allclose(float(scores.mean()), float(j_mean), rtol=1e-6, atol=1e-6)
    got = params_to_numpy(new)
    for k in tree:
        for q in tree[k]:
            assert got[k][q].dtype == np.float32
            np.testing.assert_allclose(got[k][q], np.asarray(j_new[k][q]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k}.{q}")


def test_es_learns_simple():
    """30 antithetic generations on plain K4 improve the mean episode
    return decisively (the JAX test's bound: the last five's mean within
    0.75 of the first five's magnitude)."""
    _, params = _params()
    step = es.build_es_step(kernel_scenario("simple"), params, pop=POP, sigma=SIGMA, lr=LR,
                            device="cpu", **SHAPE)
    scores = []
    for g in range(30):
        if g == 0:
            np.testing.assert_allclose(float(step.scores(params, g).mean()),
                                       float(step.plain.scores(params, g).mean()), rtol=0, atol=0)
        params, s = step(params, g)
        scores.append(float(s))
    assert all(np.isfinite(s) for s in scores)
    first, last = np.mean(scores[:5]), np.mean(scores[-5:])
    assert last > first and abs(last) < 0.75 * abs(first), (first, last)


def test_es_refuses_an_odd_population():
    _, params = _params()
    with pytest.raises(ValueError, match="even population"):
        es.build_es_step(kernel_scenario("simple"), params, pop=7, sigma=SIGMA, lr=LR,
                         device="cpu", **SHAPE)
