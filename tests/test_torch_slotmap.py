"""The slot map (`cryptonets_tpu_torch/kernels/slotmap.py`, `slotmap.cu`):
the reader's scaled values -> the index-mapped slot buffers of the device
encode, made on the device inside a fused record.

On the CPU, on rings of n = 64 and 128 with one torch thread: the plain
twin bit-equal, for one record and for three, to the JAX package's
buffers (`nn/jit.py` `slot_bufs`, its factory's `encode_bufs`) on the same
values, primes and ring, and to the port's host buffers (`encode_bufs` of
the values rounded and padded); a numpy replay of the kernel's tiles (each
buffer position written once) and of its Barrett floor modulus at the
edges of int64; the operands it refuses.

The `cuda`-marked cases need the card and run there with `python -m
pytest --noconftest tests/test_torch_slotmap.py -q -m cuda`: the kernel
bit-equal to its twin at LoLa's, CryptoNets' and LoLaSmall's shapes and
at a ragged two-block one, edge values included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.api.factory import CrtBfvFactory  # noqa: E402
from cryptonets_tpu_torch.crypto.encoder import BatchEncoder  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.kernels import slotmap  # noqa: E402
from cryptonets_tpu_torch.models.presets import CONFIGS  # noqa: E402

EDGES = (2**62, -2**62, 2**62 - 1024, -(2**62) + 1024, 0.0, 1.0, -1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _factory(P: int, n: int = 64) -> CrtBfvFactory:
    """A factory of P plain primes at ring n."""
    return CrtBfvFactory(ntt_primes(n, 20, P), n=n,
                         coeff_modulus=ntt_primes(n, 30, 3), device="cpu")


def _values(kind: str, shape, seed: int) -> np.ndarray:
    """Scaled reader values [dim, V] of a kind: integers of both signs,
    all negative, edges of int64's range, or halves (round half to even)."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        m = rng.integers(-10**6, 10**6, shape).astype(np.float64)
    elif kind == "negative":
        m = -rng.integers(1, 2**40, shape).astype(np.float64)
    elif kind == "int64_edges":
        m = rng.choice(np.array(EDGES), shape)
    else:                                            # halves
        m = rng.integers(-50, 50, shape) + 0.5
    return m


def _host_buffers(fac, m: np.ndarray) -> torch.Tensor:
    """The host's buffers of scaled values [dim, V]: each column rounded
    (half to even) and padded to C n slots, then `encode_bufs`."""
    dim, V = m.shape
    C = slotmap.blocks_of(dim, fac.n)
    ints = np.zeros((V, C * fac.n), np.int64)
    ints[:, :dim] = np.round(m.T).astype(np.int64)
    return torch.from_numpy(fac.encode_bufs(ints.reshape(V * C, fac.n)).view(np.int32))


def _jax_forward(fac: CrtBfvFactory):
    """The JAX package's EncryptedForward over a bare EncryptLayer on a
    factory of the same plain primes, ring and limbs (no keys: its slot
    buffers need none).  Imported here: the card has no JAX."""
    from cryptonets_tpu.api.factory import CrtBfvFactory as JaxFactory
    from cryptonets_tpu.nn.jit import EncryptedForward as JaxForward
    from cryptonets_tpu.nn.layers import EncryptLayer as JaxEncryptLayer

    jfac = JaxFactory(fac.plain_primes, n=fac.n,
                      coeff_modulus=list(fac.coeff_modulus), _skip_keygen=True)
    return JaxForward(JaxEncryptLayer(None, factory=jfac))


def _jax_buffers(jfwd, m: np.ndarray) -> torch.Tensor:
    """JAX's `slot_bufs` of the same scaled values: uint32 viewed as int32."""
    from cryptonets_tpu.api.raw import RawMatrix as JaxRawMatrix

    raw = JaxRawMatrix.from_scaled(m, 1.0, "col", jfwd.encrypt_layer.factory.n)
    bufs, _ = jfwd.slot_bufs(raw)
    return torch.from_numpy(np.ascontiguousarray(bufs, np.uint32).view(np.int32))


@pytest.mark.parametrize("dim,V,P,kind,R", [
    (40, 5, 4, "mixed", 1),          # dim < n: one block a column
    (100, 3, 3, "mixed", 1),         # dim > n: two blocks, the last ragged
    (64, 7, 3, "negative", 1),
    (100, 4, 4, "int64_edges", 1),
    (37, 6, 3, "halves", 1),
    (100, 3, 4, "halves", 3),        # three records: the singles one after another
], ids=["dim<n", "ragged", "negative", "int64_edges", "halves", "records3"])
def test_twin_equals_host_buffers(dim, V, P, kind, R):
    fac = _factory(P)
    ms = [_values(kind, (dim, V), seed=r + 7 * dim) for r in range(R)]
    x = torch.from_numpy(np.stack(ms))
    got = slotmap.slot_map(x, fac._slot_positions, fac.plain_primes)
    jfwd = _jax_forward(fac)
    reference = torch.cat([_jax_buffers(jfwd, m) for m in ms], dim=1)
    want = torch.cat([_host_buffers(fac, m) for m in ms], dim=1)
    C = slotmap.blocks_of(dim, fac.n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, R * V * C, fac.n)
    assert torch.equal(got, reference)
    assert torch.equal(want, reference)
    assert torch.equal(got, want)
    assert torch.equal(fac.slot_map(x), want)
    if R > 1:
        singles = [fac.slot_map(x[r:r + 1]) for r in range(R)]
        assert torch.equal(got, torch.cat(singles, dim=1))
    if kind == "halves":                 # some halves round down, to even
        assert (np.round(ms[0]) != np.floor(ms[0] + 0.5)).any()


def _barrett_mod(a: int, t: int) -> int:
    """The kernel's `floor_mod` on Python ints: |a| < 2**64, one Barrett
    quotient with m = floor(2**64 / t), one correction, the sign after."""
    (m,) = slotmap.barrett((t,))
    u = -a if a < 0 else a
    r = u - ((u * m) >> 64) * t
    assert 0 <= r < 2 * t
    if r >= t:
        r -= t
    return t - r if a < 0 and r else r


@pytest.mark.parametrize("t", [3, 65537, 557057, 786433, 2424833, 4300801,
                               ntt_primes(8192, 30, 1)[0], 2**31 - 1])
def test_barrett_floor_mod_at_int64_edges(t):
    rng = np.random.default_rng(t)
    values = [0, 1, -1, t, -t, t - 1, 1 - t, t + 1, -t - 1, 2**62, -2**62,
              2**63 - 1, -2**63, -2**63 + 1]
    values += [int(v) for v in rng.integers(-2**63, 2**63 - 1, 200, dtype=np.int64)]
    for a in values:
        assert _barrett_mod(a, t) == a % t, a


def _replay(x: np.ndarray, pos: np.ndarray, primes) -> np.ndarray:
    """`slotmap.cu`'s blocks in numpy: phase 1 (a warp a row of x across
    the block's columns, 32 at a time, rounded, into the transposed
    tile), phase 2 (a thread 4 adjacent positions of one column, each
    plane).  Returns the buffers and raises where a position is written
    twice or never."""
    R, dim, V = x.shape
    n, P = len(pos), len(primes)
    pl = slotmap.plan(R, dim, V, n)
    C, vt = pl["C"], pl["v_tiles"]
    out = np.zeros((P, R * V * C, n), np.int64)
    writes = np.zeros(out.shape, np.int64)
    warps, quads = slotmap.THREADS // 32, slotmap.TILE_J // 4
    gx, gy, gz = pl["grid"]
    for bx in range(gx):
        for by in range(gy):
            for r in range(gz):
                j0, c = bx * slotmap.TILE_J, by // vt
                v0 = (by - c * vt) * slotmap.TILE_V
                vals = np.zeros((slotmap.TILE_V, slotmap.TILE_J), object)
                for warp in range(warps):
                    for h, i in np.ndindex(slotmap.TILE_V // 32, slotmap.TILE_J // warps):
                        jj = warp + i * warps
                        j = j0 + jj
                        for lane in range(32):
                            v = v0 + 32 * h + lane
                            if j < n and v < V and c * n + pos[j] < dim:
                                vals[32 * h + lane, jj] = int(np.rint(
                                    x[r, c * n + pos[j], v]))
                for tid in range(slotmap.THREADS):
                    q = tid % quads
                    j = j0 + 4 * q
                    if j >= n:
                        continue
                    for vv in range(tid // quads, slotmap.TILE_V,
                                    slotmap.THREADS // quads):
                        if v0 + vv >= V:
                            break
                        row = (r * V + v0 + vv) * C + c
                        for k, t in enumerate(primes):
                            out[k, row, j:j + 4] = [_barrett_mod(a, t)
                                                    for a in vals[vv, 4 * q:4 * q + 4]]
                            writes[k, row, j:j + 4] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("R,dim,V,n", [(1, 40, 5, 64), (2, 300, 70, 128)],
                         ids=["one_tile", "ragged_two_column_tiles"])
def test_kernel_tiles_replayed_equal_the_twin(R, dim, V, n):
    primes = ntt_primes(n, 20, 3)
    pos = np.argsort(BatchEncoder(n, primes[0]).index_map).astype(np.int32)
    rng = np.random.default_rng(dim)
    x = rng.integers(-2**40, 2**40, (R, dim, V)).astype(np.float64)
    x[0, :4, 0] = (2**62, -2**62, 2.5, -3.5)
    got = _replay(x, pos, primes)
    want = slotmap.slot_map_plain(torch.from_numpy(x), torch.from_numpy(pos), primes)
    assert np.array_equal(got, want.numpy())


def test_plan_grid():
    assert dict(slotmap.plan(1, 169, 25, 8192)) == dict(C=1, v_tiles=1, grid=(128, 1, 1))
    assert slotmap.plan(1, 8192, 784, 8192)["grid"] == (128, 13, 1)
    assert slotmap.plan(16, 169, 25, 8192)["grid"] == (128, 1, 16)
    assert slotmap.plan(1, 9000, 140, 8192)["grid"] == (128, 6, 1)


@pytest.mark.parametrize("case", ["float32", "two_dims", "int64_map", "n_odd",
                                  "even_prime", "big_prime", "nine_primes"])
def test_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros((1, 8, 2), dtype=torch.float64)
    pos = torch.arange(8, dtype=torch.int32)
    primes = (65537,)
    if case == "float32":
        x = x.float()
    elif case == "two_dims":
        x = x[0]
    elif case == "int64_map":
        pos = pos.long()
    elif case == "n_odd":
        pos = pos[:6]
    elif case == "even_prime":
        primes = (65536,)
    elif case == "big_prime":
        primes = (2**31 + 11,)
    else:
        primes = (65537,) * 9
    with pytest.raises(ValueError):
        slotmap.slot_map(x, pos, primes)


# ------------------------------------------------------------- on the card
SHAPES = {   # (records, dim, columns, preset): the paths' launches
    "lola": (1, 169, 25, "lola"),
    "cryptonets": (1, 8192, 784, "cryptonets"),
    "lola_small_batch16": (16, 169, 25, "lola_small"),
    "ragged_two_blocks": (2, 9000, 40, "lola"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(SHAPES))
def test_cuda_kernel_bit_equal_to_twin(which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the card)")
    R, dim, V, preset = SHAPES[which]
    n, primes = CONFIGS[preset]["n"], CONFIGS[preset]["plain_primes"]
    pos = np.argsort(BatchEncoder(n, primes[0]).index_map).astype(np.int32)
    rng = np.random.default_rng(dim + V)
    x = rng.integers(-2**40, 2**40, (R, dim, V)).astype(np.float64)
    x[0, :len(EDGES), 0] = EDGES
    x[-1, :40, -1] = np.arange(-20, 20) + 0.5
    xc, pc = torch.from_numpy(x).cuda(), torch.from_numpy(pos).cuda()
    before = slotmap.LAUNCHES["slot_map"]
    got = slotmap.slot_map(xc, pc, primes)
    torch.cuda.synchronize()
    assert slotmap.LAUNCHES["slot_map"] == before + 1
    want = slotmap.slot_map_plain(torch.from_numpy(x), torch.from_numpy(pos), primes)
    assert torch.equal(got.cpu(), want)
