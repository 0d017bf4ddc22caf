"""The 3xTF32 pieces of the wide float32 update kernel (``csrc/tf32_mma.cuh``,
``csrc/mpe_update.cu`` at hidden 128 and 256) compiled for the host
(``tests/_csrc_host.py``):

- ``tf32_rna`` (``cvt.rna.tf32.f32``) on chosen bit patterns: round to
  nearest with ties away from zero (where round-to-nearest-even would go the
  other way), carries into the exponent, signed values, infinities and NaN;
- the split ``x = hi + lo`` on random float32 values: each product
  ``hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b)`` within 2^-19 of ``a b``
  relative (float64 reference), where the one-term TF32 product is not;
- ``warp_mma3`` through the emulated ``mma.sync`` m16n8k8 tf32 in its
  fragment layout: one k8 step of a 16 x 8 x 8 product, each output within
  2^-19 of the float64 one relative to the sum of its terms' magnitudes;
- the cluster kernel, K6 and K7, over 3 clusters (2 CTAs each at 128, 4 at
  256) on simple_spread (72 envs: ragged tiles staged element by element)
  and simple_speaker_listener (128 envs, 16-byte pieces), on epoch-0 batches
  and where both clips bind: each gradient leaf within 1e-4 of its largest
  entry of the plain version, the metrics within 1e-4 relative;
- every wide instantiation's shared memory within a CTA's 227 KB, and the
  grid the wrapper asks for: the stand-in card's clusters.
"""

import ctypes

import numpy as np
import pytest

from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario
from tests._csrc_host import HOST_SMS, MAX_SMEM_FLOATS, build_host_libs_at
from tests.test_torch_csrc_host import _check_host_update
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (128, 256)
CLUSTER = {128: 2, 256: 4}
# a test source of its own beside the headers: the rounding, the split and
# one warp's 3xTF32 product
PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32_mma.cuh"

namespace {

// D [16][8] = A [16][8] B [8][8] by warp_mma3, A and B row-major
__global__ void mma_probe(const float* A, const float* B, float* D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[1][1][4] = {};
  warp_mma3<1, 1, 1>(
      [&](int, int, float (&a)[4]) {
        a[0] = A[g * 8 + t];
        a[1] = A[(g + 8) * 8 + t];
        a[2] = A[g * 8 + t + 4];
        a[3] = A[(g + 8) * 8 + t + 4];
      },
      [&](int, int, float (&b)[2]) {
        b[0] = B[t * 8 + g];
        b[1] = B[(t + 4) * 8 + g];
      },
      acc);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = acc[0][0][i];
}

}  // namespace

extern "C" {

int tf32_round(const float* x, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tf32_rna(x[i]);
  return 0;
}

int tf32_split(const float* x, uint32_t* hi, uint32_t* lo, int n) {
  for (int i = 0; i < n; ++i) {
    float v[1] = {x[i]};
    uint32_t h[1], l[1];
    split_tf32(v, h, l);
    hi[i] = h[0];
    lo[i] = l[0];
  }
  return 0;
}

int tf32_mma_probe(const float* A, const float* B, float* D, cudaStream_t stream) {
  mma_probe<<<1, 32, 0, stream>>>(A, B, D);
  return 0;
}

}  // extern "C"
"""
_P = ctypes.c_void_p
PROBE_SIGNATURES = {"tf32_round": [_P, _P, ctypes.c_int],
                    "tf32_split": [_P, _P, _P, ctypes.c_int],
                    "tf32_mma_probe": [_P, _P, _P, _P]}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    path = tmp_path_factory.mktemp("tf32") / "tf32_probe.cu"
    path.write_text(PROBE)
    return build_host_libs_at([(str(path), 128)], {"tf32_probe.cu": PROBE_SIGNATURES})[
        str(path), 128]


@pytest.fixture(scope="module")
def update_libs():
    """``mpe_update.cu`` at 128 and 256, built at once."""
    return build_host_libs_at([("mpe_update.cu", h) for h in WIDTHS])



def _floats(u: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(u, dtype=np.uint32).view(np.float32)


def _rna_reference(u: np.ndarray) -> np.ndarray:
    """Round the float32 bit patterns ``u`` to 10 fraction bits, to nearest,
    ties away from zero (the magnitude's bits rounded; the sign kept)."""
    u = u.astype(np.uint64)
    mag, sign = u & 0x7FFFFFFF, u & 0x80000000
    kept, rest = mag & ~np.uint64(0x1FFF), mag & 0x1FFF
    kept = np.where(rest >= 0x1000, kept + 0x2000, kept)
    return (sign | kept).astype(np.uint32)


def test_cvt_rna_rounds_ties_away_from_zero(probe):
    """``tf32_rna`` on bit patterns at, just below and just above each
    rounding boundary, both signs: ties round away from zero (a tie whose
    kept bit is even too, where round-to-nearest-even would truncate), a
    full fraction carries into the exponent, and infinities and NaN pass."""
    base = [0x3F800000, 0x3F802000, 0x40490FDB, 0x00800000, 0x3FFFE000]
    patterns = []
    for b in base:
        for low in (0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF):
            patterns += [b | low, (b | low) | 0x80000000]
    patterns += [0x3FFFF000, 0x7F7FF000, 0x7F800000, 0xFF800000]
    u = np.array(patterns, dtype=np.uint32)
    out = np.empty_like(u)
    probe.tf32_round(_floats(u).ctypes.data, out.ctypes.data, len(u))
    want = _rna_reference(u)                                 # the infinities unchanged
    assert np.array_equal(out, want), [(hex(a), hex(b), hex(c)) for a, b, c in zip(u, out, want)
                                       if b != c]
    assert not np.any(out & 0x1FFF), "the low 13 bits are zero"
    tie_even = np.uint32(0x3F801000)                         # 1 + 2^-11: kept bit 0, a tie
    assert out[np.flatnonzero(u == tie_even)[0]] == 0x3F802000, "a tie rounds away from zero"
    assert out[np.flatnonzero(u == (tie_even | 0x80000000))[0]] == 0xBF802000
    nan = np.array([0x7FC00000, 0x7F800001], dtype=np.uint32)
    out = np.empty_like(nan)
    probe.tf32_round(_floats(nan).ctypes.data, out.ctypes.data, 2)
    assert np.isnan(_floats(out)).all()


def test_split_products_within_2_pow_minus_19(probe):
    """For random float32 a, b over 12 binades of both signs, hi(a) hi(b) +
    hi(a) lo(b) + lo(a) hi(b) from the split lies within 2^-19 of a b relative
    (float64), hi and lo are tf32 values, and a = hi + lo exactly up to lo's
    own rounding; the single TF32 product hi(a) hi(b) does not get near."""
    rng = np.random.default_rng(0)
    n = 20000
    x = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-6, 6, n)
         * rng.choice([-1, 1], n)).astype(np.float32)
    hi, lo = np.empty(n, np.uint32), np.empty(n, np.uint32)
    probe.tf32_split(x.ctypes.data, hi.ctypes.data, lo.ctypes.data, n)
    assert not np.any((hi | lo) & 0x1FFF), "hi and lo are tf32"
    h, l = _floats(hi).astype(np.float64), _floats(lo).astype(np.float64)
    xd = x.astype(np.float64)
    assert np.all(np.abs(xd - (h + l)) <= 2.0 ** -21 * np.abs(xd))
    a, b = slice(0, n // 2), slice(n // 2, n)
    exact = xd[a] * xd[b]
    three = h[a] * h[b] + h[a] * l[b] + l[a] * h[b]
    rel = np.abs(three - exact) / np.abs(exact)
    assert rel.max() <= 2.0 ** -19, rel.max()
    one = np.abs(h[a] * h[b] - exact) / np.abs(exact)
    assert one.max() > 2.0 ** -12, one.max()


def test_warp_mma3_matches_float64_through_the_fragments(probe):
    """One warp's 3xTF32 m16n8k8 product through the emulated mma.sync in its
    fragment layout: every output of D = A B within 2^-19 of the float64
    product relative to the sum of its terms' magnitudes, for three random
    A [16][8], B [8][8] (entries spread over 8 binades, both signs)."""
    rng = np.random.default_rng(1)
    for _ in range(3):
        A = (rng.standard_normal((16, 8)) * 2.0 ** rng.integers(-4, 4, (16, 8))).astype(np.float32)
        B = (rng.standard_normal((8, 8)) * 2.0 ** rng.integers(-4, 4, (8, 8))).astype(np.float32)
        D = np.empty((16, 8), np.float32)
        probe.tf32_mma_probe(A.ctypes.data, B.ctypes.data, D.ctypes.data, None)
        exact = A.astype(np.float64) @ B.astype(np.float64)
        scale = np.abs(A.astype(np.float64)) @ np.abs(B.astype(np.float64))
        rel = np.abs(D - exact) / scale
        assert rel.max() <= 2.0 ** -19, rel.max()


@pytest.mark.parametrize("clip_binding", [False, True], ids=["epoch0", "clips_bind"])
@pytest.mark.parametrize("kind", ["ppo", "mappo"])
@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_cluster_kernel_matches_plain(update_libs, hidden, name, kind, clip_binding):
    """K6 (``ppo``) or K7 (``mappo``: the actor and the critic pass) of the
    library built at ``hidden`` over 3 clusters on one step of a batch
    (simple_spread: 72 envs, tiles across the rows of the batch and a ragged
    last one; simple_speaker_listener: 128 envs), epoch-0 or with both clips
    binding for about half of the samples: each leaf within 1e-4 of its
    largest entry, the metrics within 1e-4 relative."""
    n = 72 if name == "simple_spread" else 128
    err = _check_host_update(update_libs["mpe_update.cu", hidden], kernel_scenario(name), kind,
                             1, n, clip_binding, hidden)
    assert err <= 1e-4


@pytest.mark.parametrize("hidden", WIDTHS)
def test_cluster_grid_and_shared_memory(update_libs, hidden):
    """Every wide pass (K6 and K7's actor on the nine heads, K7's critic on
    the nine joint widths) asks for at most a CTA's dynamic shared memory,
    and its grid is the clusters of the stand-in card (HOST_SMS SMs over
    clusters of 2 CTAs at 128, 4 at 256); an uncompiled head asks for none."""
    lib = update_libs["mpe_update.cu", hidden]
    for name in _KERNEL_SCENARIOS:
        kscn = kernel_scenario(name)
        a, ow, kc = kscn.spec.n_agents, kscn.obs_w, kscn.n_comm
        passes = [(ow, kc, 0), (ow, kc, 1), (a * ow, 0, 2)]
        sizes = [lib.mpe_update_smem(*p) for p in passes]
        assert all(0 < s <= 4 * MAX_SMEM_FLOATS for s in sizes), (name, sizes)
        grids = [lib.mpe_update_grid(*p) for p in passes]
        assert grids == [HOST_SMS // CLUSTER[hidden]] * 3, (name, grids)
    assert lib.mpe_update_grid(7, 0, 0) == lib.mpe_update_smem(55, 0, 2) == -1
