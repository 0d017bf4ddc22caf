"""The bf16 fragment paths of ``csrc/bf16_mma.cuh`` and K9-bf16's rounding
pass (``csrc/mpe_maddpg_bf16.cu``), compiled for the host
(``tests/_csrc_host.py``).

- The ldmatrix helpers' host paths (each lane reads the elements the PTX
  ISA's fragment table gives it): every fragment a product takes, plain
  (``frag_a_mk``, ``frag_b_nk``, ``frag_b2_nk``) and ``.trans``
  (``frag_a_km``, ``frag_b_kn``, ``frag_b2_kn``), equal bit for bit to the
  fragments that the kernels built before ldmatrix (``frag_a_bf16`` from a
  bf16 matrix, ``frag_b_rows`` from a float32 tile, rounded) give on the same
  tile, at several row strides and block offsets.
- K9-bf16's rounding pass, run by a whole launch: its bf16 scratch (after
  the partials, ``partials_floats``) holds every net of the weight buffer as
  exactly ``bf16(w)`` (round to nearest even, as torch rounds) in the padded
  rows the layout constants give, with zeros in every padding row and column.
"""

import ctypes

import numpy as np
import pytest
import torch

from mpe_tpu_torch.learner.maddpg import init_maddpg
from mpe_tpu_torch.ops import _build, fused_maddpg_update
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs_at
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = "mpe_maddpg_bf16.cu"
WIDTHS = (64, 16)
MW = 5
# a test source of its own beside the headers: the fragments through the
# helpers and through the two helpers the kernels used before ldmatrix
PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "bf16_mma.cuh"

namespace {

// the A fragment of rows m0 .., columns k0 .. of a bf16 matrix [.][ld]
void frag_a_bf16(const uint16_t* W, int ld, int m0, int k0, int lane, uint32_t (&a)[4]) {
  const uint16_t* p = W + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// the B fragment of rows k0 .. (the contraction) and columns n0 .. of a
// float32 tile [k][ld], rounded
void frag_b_rows(const float* T, int ld, int k0, int n0, int lane, uint32_t (&b)[2]) {
  const float* p = T + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

__global__ void frag_kernel(const uint16_t* M, const float* F, int ld, int r0, int c0,
                            uint32_t* out) {
  const int lane = threadIdx.x & 31;
  uint32_t* o = out + lane * 40;
  uint32_t a[4], ra[4], b[2], rb[2], rb8[2], b2[2][2];
  frag_a_bf16(M, ld, r0, c0, lane, ra);
  frag_b_rows(F, ld, r0, c0, lane, rb);
  frag_b_rows(F, ld, r0, c0 + 8, lane, rb8);
  frag_a_mk(M, ld, r0, c0, lane, a);                      // A from [m][k]
  for (int i = 0; i < 4; ++i) o[i] = a[i], o[4 + i] = ra[i];
  frag_b_kn(M, ld, r0, c0, lane, b);                      // B from [k][n]
  o[8] = b[0], o[9] = b[1], o[10] = rb[0], o[11] = rb[1];
  frag_b2_kn(M, ld, r0, c0, lane, b2);
  o[12] = b2[0][0], o[13] = b2[0][1], o[14] = b2[1][0], o[15] = b2[1][1];
  o[16] = rb[0], o[17] = rb[1], o[18] = rb8[0], o[19] = rb8[1];
  frag_b_nk(M, ld, r0, c0, lane, b);                      // B from [n][k]
  o[20] = b[0], o[21] = b[1], o[22] = ra[0], o[23] = ra[2];
  frag_b2_nk(M, ld, r0, c0, lane, b2);
  o[24] = b2[0][0], o[25] = b2[0][1], o[26] = b2[1][0], o[27] = b2[1][1];
  o[28] = ra[0], o[29] = ra[2], o[30] = ra[1], o[31] = ra[3];
  frag_a_km(M, ld, r0, c0, lane, a);                      // A from [k][m]
  for (int i = 0; i < 4; ++i) o[32 + i] = a[i];
  o[36] = rb[0], o[37] = rb8[0], o[38] = rb[1], o[39] = rb8[1];
}

}  // namespace

extern "C" int mpe_frag_probe(const uint16_t* M, const float* F, int ld, int r0, int c0,
                              uint32_t* out, cudaStream_t stream) {
  frag_kernel<<<1, 32, 0, stream>>>(M, F, ld, r0, c0, out);
  return 0;
}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int
PROBE_SIGNATURES = {"frag_probe.cu": {"mpe_frag_probe": [_P, _P, _I, _I, _I, _P, _P]}}
# (row stride, first row, first column): strides of lda(16), lda(32), lda(64), lda(272)
FRAG_CASES = [(24, 0, 0), (40, 16, 8), (72, 8, 24), (72, 48, 56), (280, 0, 256)]


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The probe source and the K9-bf16 source at widths 64 and 16, built at
    once."""
    probe = tmp_path_factory.mktemp("bf16_frag_host") / "frag_probe.cu"
    probe.write_text(PROBE)
    libs = build_host_libs_at([(probe, 64)] + [(SOURCE, h) for h in WIDTHS], PROBE_SIGNATURES)
    libs["frag_probe.cu", 64] = libs.pop((probe, 64))
    return libs


@pytest.mark.parametrize("ld, r0, c0", FRAG_CASES)
def test_ldmatrix_host_paths_equal_the_scalar_fragments(host_libs, ld, r0, c0):
    lib = host_libs["frag_probe.cu", 64]
    rows = r0 + 16
    rng = np.random.default_rng(ld + r0 + c0)
    values = torch.from_numpy(rng.standard_normal((rows, ld)).astype(np.float32))
    bf = values.to(torch.bfloat16)
    bits = bf.view(torch.int16).contiguous()
    floats = bf.float().contiguous()                 # the bf16 values, exact in float32
    out = torch.zeros((32, 40), dtype=torch.int32)
    assert lib.mpe_frag_probe(bits.data_ptr(), floats.data_ptr(), ld, r0, c0, out.data_ptr(),
                              None) == 0
    for name, got, want in (("frag_a_mk", (0, 4), (4, 8)), ("frag_b_kn", (8, 10), (10, 12)),
                            ("frag_b2_kn", (12, 16), (16, 20)), ("frag_b_nk", (20, 22), (22, 24)),
                            ("frag_b2_nk", (24, 28), (28, 32)), ("frag_a_km", (32, 36), (36, 40))):
        assert torch.equal(out[:, got[0]:got[1]], out[:, want[0]:want[1]]), name
    assert out[:, :4].ne(0).any()                    # the fragments were written


def _rounding_case(lib, name: str, hidden: int):
    """One whole K9-bf16 launch on 16 random rows -> (its bf16 scratch as
    int16, the weight buffer, the layout constants, the PackedLayout)."""
    kscn = kernel_scenario(name)
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    b = 16
    params = init_maddpg(torch.Generator().manual_seed(3), o, k, a, hidden=hidden)
    gen = torch.Generator().manual_seed(4)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen) for w, x in layer.items()}
                   for q, layer in net.items()} for n, net in params.items()}
    lay = fused_maddpg_update.PackedLayout(a, o, k, hidden)
    wbuf = lay.pack(params, targets)
    rows = torch.randn((b, a * (2 * o + k + 1)), generator=gen)
    act2 = torch.empty((a, 2 if k > MW else 1, b), dtype=torch.int32)
    y = torch.empty((a, b))
    partials = torch.full((fused_maddpg_update.partials_floats(lib, scenario, a, b),), 7.0)
    grads, metrics = torch.empty(lay.off_ta), torch.empty(3)
    assert lib.mpe_maddpg_update(scenario, wbuf.data_ptr(), rows.data_ptr(), act2.data_ptr(),
                                 y.data_ptr(), partials.data_ptr(), grads.data_ptr(),
                                 metrics.data_ptr(), b, 0.95, 0.01, 1.0 / (a * b), None) == 0
    consts = [lib.mpe_maddpg_update_layout(scenario, q) for q in range(11)]
    n_scratch = consts[5]
    scratch = partials[partials.numel() - n_scratch:].view(torch.int16)
    return scratch, wbuf, consts, lay


def _want_net(block, n_in: int, n_out: int, hidden: int, l1: int, lh: int):
    """A net's kernel-layout block of the weight buffer as the padded bf16
    rows W1 [HP][l1], W2 [HP][lh], W3 [16][lh] (zeros in the padding)."""
    hp = max(hidden, 16)
    w1 = block[:hidden * n_in].reshape(hidden, n_in)
    w2 = block[hidden * n_in + hidden:][:hidden * hidden].reshape(hidden, hidden)
    w3 = block[hidden * n_in + 2 * hidden + hidden * hidden:][:n_out * hidden].reshape(n_out, hidden)
    out = []
    for w, rows, ld in ((w1, hp, l1), (w2, hp, lh), (w3, 16, lh)):
        pad = torch.zeros((rows, ld))
        pad[:w.shape[0], :w.shape[1]] = w
        out.append(pad.to(torch.bfloat16).view(torch.int16).reshape(-1))
    return torch.cat(out)


@pytest.mark.parametrize("name", ["simple_spread", "simple_world_comm"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_k9_bf16_rounding_pass_writes_bf16_of_every_net(host_libs, hidden, name):
    scratch, wbuf, consts, lay = _rounding_case(host_libs[SOURCE, hidden], name, hidden)
    n_actor, n_critic, l1a, l1c, lh = consts[6:11]
    a = lay.a
    nets = [("actor", q) for q in range(a)] + [("critic", q) for q in range(a)]
    nets = nets + [("target " + kind, q) for kind, q in nets]
    offsets = {"actor": 0, "critic": lay.off_c, "target actor": lay.off_ta,
               "target critic": lay.off_ta + lay.off_c}
    at = 0
    for kind, q in nets:
        critic = kind.endswith("critic")
        stride, size = (lay.ncp, n_critic) if critic else (lay.nwp, n_actor)
        block = wbuf[offsets[kind] + q * stride:][:stride]
        want = _want_net(block, lay.j if critic else lay.o, 1 if critic else lay.k, hidden,
                         l1c if critic else l1a, lh)
        assert want.numel() == size, (kind, q)
        assert torch.equal(scratch[at:at + size], want), f"{kind} {q} at hidden {hidden}"
        at += size
    assert at == scratch.numel()
