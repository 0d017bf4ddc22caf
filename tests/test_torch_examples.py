"""The port's example scripts (``mpe_tpu_torch.examples``) on the CPU.

Each script's ``main`` runs with ``--device cpu`` at a tiny size and must
return finite figures. Where a script computes what the JAX package's
example computes from the same inputs, the two are held equal: the greedy
actions ``render_policy`` takes from the committed speaker_listener
checkpoint (argmax of ``actor_logits_i``), ``crypto_demo``'s codebook and
optimal-decoder errors from the committed crypto checkpoint, and the
per-env logits ``train.greedy_eval`` acts on for each algorithm (float32 on
both sides, within 1e-5, argmax equal).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpe_tpu.learner as j_learner
import mpe_tpu.learner.maddpg as j_maddpg
import mpe_tpu.learner.pg as j_pg
import mpe_tpu.learner.ppo as j_ppo
from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from mpe_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mpe_tpu_torch import make_env
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy
from mpe_tpu_torch.examples import (_crypto, crypto_demo, es_train, evaluate_policy, maddpg_run,
                                    render_policy, rollout, train)
from mpe_tpu_torch.learner import init_maddpg, maddpg_act_dim
from mpe_tpu_torch.utils.checkpoint import load_checkpoint
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SL_CKPT = str(REPO / "checkpoints" / "maddpg_speaker_listener.npz")
CRYPTO_CKPT = str(REPO / "checkpoints" / "crypto_pbt_grace_repro_s2_m5.npz")
TINY_TRAIN = ["--iters", "2", "--n-envs", "8", "--n-steps", "8"]

CASES = {
    "rollout": (rollout, ["--n-envs", "64", "--n-steps", "20"]),
    "rollout_fused": (rollout, ["--n-envs", "64", "--n-steps", "20", "--fused"]),
    "evaluate_policy": (evaluate_policy, ["--n-envs", "64", "--n-steps", "60", "--horizon", "25",
                                          "--hidden", "16", "--scenario", "simple_reference"]),
    "es_train": (es_train, ["--n-envs", "32", "--n-steps", "10", "--gens", "2", "--pop", "4",
                            "--hidden", "16"]),
    **{f"train_{a}": (train, ["--algo", a] + TINY_TRAIN)
       for a in ("reinforce", "ppo", "mappo", "maddpg", "fused_ppo", "fused_mappo")},
    "train_maddpg_fused_collect": (train, ["--algo", "maddpg", "--fused-collect", "--iters", "2",
                                           "--n-envs", "8"]),
    "maddpg_run": (maddpg_run, ["--scenario", "simple_speaker_listener", "--updates", "50",
                                "--n-envs", "8", "--batch", "64", "--actor-start", "0"]),
    "render_policy": (render_policy, ["--checkpoint", SL_CKPT, "--episodes", "2",
                                      "--steps", "3"]),
    "crypto_demo": (crypto_demo, ["--episodes", "3"]),
}


def _numbers(x):
    """Every number in a figures dict, nested containers included."""
    if isinstance(x, dict):
        return [n for v in x.values() for n in _numbers(v)]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in _numbers(v)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


@pytest.mark.parametrize("case", list(CASES))
def test_example_runs_on_cpu(case, capsys):
    module, argv = CASES[case]
    figures = module.main(argv + ["--device", "cpu"])
    numbers = _numbers(figures)
    assert numbers and all(math.isfinite(n) for n in numbers), figures
    assert capsys.readouterr().out
    if case == "es_train":
        assert sorted(figures["mean_return_by_generation"]) == [0, 1]
    if case == "render_policy":
        assert figures["frames"] == 6 and figures["frame_shape"] == (700, 700, 3)
        assert figures["checkpoint_step"] == 24000
    if case == "maddpg_run":
        assert figures["updates"] == 50 and "greedy_muted_comm" in figures
    if case.startswith("train_"):
        assert figures["last"]["iter"] == 1


def test_example_checkpoints_cross_packages(tmp_path):
    """``evaluate_policy --load`` reads a JAX-format checkpoint; ``train
    --save`` and ``maddpg_run --save`` write ones the JAX package reads."""
    kscn_w, hidden = 21, 16   # simple_reference: obs width 21, 5 + 10 logits
    j_params = j_learner.init_policy(jax.random.PRNGKey(3), kscn_w, 15, hidden=hidden)
    path = str(tmp_path / "reinforce.npz")
    j_save_checkpoint(path, jax.tree.map(lambda x: np.asarray(x, np.float32), j_params), step=7)
    figures = evaluate_policy.main(["--scenario", "simple_reference", "--n-envs", "32",
                                    "--n-steps", "30", "--horizon", "10", "--hidden", "16",
                                    "--load", path, "--device", "cpu"])
    assert figures["checkpoint_step"] == 7 and math.isfinite(figures["mean_return"])
    with pytest.raises(ValueError, match="checkpoint layer"):
        evaluate_policy.main(["--scenario", "simple_reference", "--n-envs", "32", "--n-steps",
                              "30", "--hidden", "32", "--load", path, "--device", "cpu"])

    saved = str(tmp_path / "maddpg.npz")
    maddpg_run.main(["--updates", "25", "--n-envs", "8", "--batch", "64", "--save", saved,
                     "--device", "cpu"])
    like = j_learner.init_maddpg(jax.random.PRNGKey(0), 18, 5, 3)
    payload, step, _ = j_load_checkpoint(saved, {"state": like})
    assert step == 25
    assert jax.tree.structure(payload["state"]) == jax.tree.structure(like)


def test_render_policy_greedy_actions_match_jax():
    env = make_env("simple_speaker_listener", seed=4, device="cpu")
    spec, ow = env.world_spec, env.scenario.obs_width
    aw = maddpg_act_dim(env.env)
    like = init_maddpg(torch.Generator().manual_seed(0), ow, aw, env.n)
    params = params_from_numpy(load_checkpoint(SL_CKPT, {"state": like})[0]["state"],
                               device="cpu")
    j_like = j_learner.init_maddpg(jax.random.PRNGKey(0), ow, aw, env.n)
    j_params = j_load_checkpoint(SL_CKPT, {"state": j_like})[0]["state"]
    policy = render_policy.greedy_policy(env, params)
    obs_n = env.reset()
    mw = 2 * spec.dim_p + 1
    for _ in range(12):
        acts = policy(obs_n)
        for i in range(env.n):
            o = np.zeros(ow, np.float32)
            o[:len(obs_n[i])] = obs_n[i]
            logits = np.asarray(j_maddpg.actor_logits_i(
                jax.tree.map(lambda x: x[i], j_params["actor"]), jnp.asarray(o)))
            segs = []
            if spec.movable[i]:
                segs.append(np.eye(mw)[int(np.argmax(logits[:mw]))])
            if not spec.silent[i]:
                segs.append(np.eye(spec.dim_c)[int(np.argmax(logits[mw:]))])
            np.testing.assert_array_equal(acts[i], np.concatenate(segs))
        obs_n, *_ = env.step(acts)


def _crypto_study():
    spec = importlib.util.spec_from_file_location("crypto_study_ref",
                                                  REPO / "tools" / "crypto_study.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_crypto_codebook_and_best_response_match_jax():
    study = _crypto_study()
    scn = t_scenarios.load("simple_crypto")
    aw = maddpg_act_dim(make_env("simple_crypto", device="cpu").env)
    like = init_maddpg(torch.Generator().manual_seed(0), scn.obs_width, aw, 3)
    params = params_from_numpy(load_checkpoint(CRYPTO_CKPT, {"state": like})[0]["state"],
                               device="cpu")
    j_like = j_learner.init_maddpg(jax.random.PRNGKey(0), scn.obs_width, aw, 3)
    j_params = j_load_checkpoint(CRYPTO_CKPT, {"state": j_like})[0]["state"]
    # JAX's codebook as tools/crypto_study.eval_seed computes it
    mw, dim_c = 2 * scn.spec.dim_p + 1, scn.spec.dim_c
    obs = np.zeros((4, scn.obs_width), np.float32)
    for r, (g, k) in enumerate(_crypto.codebook_pairs()):
        obs[r, g] = obs[r, dim_c + k] = 1.0
    alice = jax.tree.map(lambda x: x[study.ALICE], j_params["actor"])
    j_logits = np.asarray(jax.vmap(lambda o: j_maddpg.actor_logits_i(alice, o))(jnp.asarray(obs)))
    logits = _crypto.alice_logits(scn, params, device="cpu")
    np.testing.assert_allclose(logits, j_logits, rtol=0, atol=1e-5)
    j_book = {f"goal{g}_key{k}": int(m) for m, (g, k) in
              zip(j_logits[:, mw:].argmax(-1), _crypto.codebook_pairs())}
    book = _crypto.eval_seed(scn, params, n_envs=32, device="cpu")["alice_codebook"]
    assert book == j_book
    assert _crypto.best_response_errs(book) == study.best_response_errs(j_book) == (0.0, 1.0)
    assert (_crypto.EVE, _crypto.BOB, _crypto.ALICE) == (study.EVE, study.BOB, study.ALICE)
    # every codebook of four messages from four letters
    for code in np.ndindex(4, 4, 4, 4):
        cb = {f"goal{g}_key{k}": m for m, (g, k) in zip(code, _crypto.codebook_pairs())}
        assert _crypto.best_response_errs(cb) == study.best_response_errs(cb)


@pytest.mark.parametrize("algo", train.ALGOS)
def test_greedy_eval_logits_match_jax(algo):
    name = "simple_reference"
    scn = j_scenarios.load(name)
    a, ow = scn.spec.n_agents, scn.obs_width
    mw = 2 * scn.spec.dim_p + 1
    key = jax.random.PRNGKey(11)
    if algo == "maddpg":
        j_params = j_learner.init_maddpg(key, ow, maddpg_act_dim(make_env(name, device="cpu").env),
                                         a)
    elif algo in ("mappo", "fused_mappo"):
        j_params = j_learner.init_mappo(key, ow, mw, a)
    elif algo in ("ppo", "fused_ppo"):
        j_params = j_learner.init_ac(key, ow, mw)
    else:
        j_params = j_learner.init_policy(key, ow, make_env(name, device="cpu").env.action_width)
    j_params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), j_params)
    obs = np.random.default_rng(0).normal(size=(16, a, ow)).astype(np.float32)

    def j_per_env(o):   # examples/train.py:greedy_eval's per_env_logits
        if algo == "maddpg":
            return jax.vmap(j_maddpg.actor_logits_i)(j_params["actor"], o)
        if algo in ("mappo", "fused_mappo"):
            return j_ppo.actor_logits(j_params, o)
        if algo in ("ppo", "fused_ppo"):
            return j_ppo.policy_value(j_params, o)[0]
        return j_pg.policy_logits(j_params, o)

    want = np.asarray(jax.vmap(j_per_env)(jnp.asarray(obs)))
    params = params_from_numpy(jax.tree.map(np.asarray, j_params), device="cpu")
    got = train.per_env_logits(algo, params, torch.as_tensor(obs)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., :mw].argmax(-1), want[..., :mw].argmax(-1))
    g = train.greedy_eval(t_scenarios.load(name), algo, params, n_envs=8, n_steps=5,
                          device="cpu")
    assert math.isfinite(g)
