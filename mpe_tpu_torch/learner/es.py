"""Evolution strategies on the policy-evaluation kernel K4 (counterpart of
``mpe_tpu/learner/es.py``).

OpenAI-ES (Salimans et al. 2017) with antithetic sampling and rank
shaping: each generation draws Gaussian perturbation pairs of the policy,
scores every member by rolling out thousands of envs inside kernel K4
(``ops/fused_policy.fused_policy_rollout``: obs -> MLP -> Gumbel-max
sample -> physics, one launch per member), and ascends the rank-weighted
score gradient. Common random numbers (the same kernel seed ``gen`` for
every member of a generation) cancel environment luck out of the member
comparison. JAX's ``lax.scan`` over the members is a loop of ``pop``
launches on one stream; the noise comes from a ``torch.Generator`` seeded
from ``gen``, so its values differ from JAX's.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.learner.optim import tree_leaves, tree_unflatten
from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout

_NOISE_SEED = 17    # JAX folds gen into PRNGKey(17)


def _noise(params, gen: int, half: int):
    """``half`` standard-normal perturbations of every leaf, ``[half,
    *leaf.shape]`` in ``tree_leaves`` order, from a generator seeded from
    ``gen`` on the params' device."""
    leaves = tree_leaves(params)
    g = torch.Generator(device=leaves[0].device).manual_seed((_NOISE_SEED << 32) + int(gen))
    return [torch.randn((half,) + tuple(x.shape), generator=g, dtype=x.dtype, device=x.device)
            for x in leaves]


def _es_update(params, noise, scores, sigma: float, lr: float):
    """Rank shaping of the member ``scores [pop]`` (+ members first, then
    their - twins) to centered weights in [-0.5, 0.5], and the step
    ``lr * (w+ - w-) . noise / (pop * sigma)`` on every leaf."""
    pop = scores.shape[0]
    half = pop // 2
    order = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    w = order.to(torch.float32) / (pop - 1) - 0.5
    dw = (w[:half] - w[half:]).to(noise[0].dtype)
    leaves = [x + lr * (torch.tensordot(dw, n, dims=1) / (pop * sigma))
              for x, n in zip(tree_leaves(params), noise)]
    return tree_unflatten(params, leaves)


def _score(rollout, theta, gen: int):
    """Mean return per episode over the lanes of one rollout of ``theta``."""
    ret, _, eps = rollout(gen, theta)
    return (ret.sum(0) / eps[0].clamp_min(1.0)).mean()


def _member_scores(rollout, params, noise, gen: int, sigma: float):
    """Scores ``[pop]`` of the + members ``params + sigma * noise[i]``, then
    of their - twins, each one ``rollout`` with the kernel seed ``gen``."""
    leaves = tree_leaves(params)

    def member(sign, i):
        return tree_unflatten(params, [x + sign * sigma * n[i] for x, n in zip(leaves, noise)])

    return torch.stack([_score(rollout, member(sign, i), gen)
                        for sign in (1.0, -1.0) for i in range(noise[0].shape[0])])


def build_es_step(kscn, params, n_envs, n_steps, horizon, pop, sigma, lr, device=None):
    """-> ``step(params, gen) -> (params, mean_score)``; one generation of
    antithetic OpenAI-ES with rank shaping. ``pop`` counts the +/- pair
    members (must be even); ``params`` is a ``learner.init_policy`` tree
    (its shapes fix the kernel's widths). On a CUDA device each member is
    one launch of K4; ``step.plain`` is the same step with K4's plain
    version, and ``step.scores(params, gen)`` (``step.plain.scores``) the
    generation's member scores ``[pop]`` alone."""
    if pop % 2:
        raise ValueError(f"antithetic pairs need an even population, got {pop}")
    half = pop // 2
    run = fused_policy_rollout(kscn, params, n_envs=n_envs, n_steps=n_steps, horizon=horizon,
                               block_envs=min(1024, n_envs), device=device)

    def make(rollout):
        def scores(params, gen):
            return _member_scores(rollout, params, _noise(params, gen, half), gen, sigma)

        def step(params, gen):
            noise = _noise(params, gen, half)
            s = _member_scores(rollout, params, noise, gen, sigma)
            return _es_update(params, noise, s, sigma, lr), s.mean()

        step.scores = scores
        return step

    step = make(run)
    step.plain = make(run.plain)
    return step
