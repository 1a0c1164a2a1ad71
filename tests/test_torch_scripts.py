"""The core functions of the port's counterparts of the reference scripts,
on the CPU at tiny sizes:

  * `scripts/torch_parity_evidence.py`: the Raw oracle's peak message
    bits of `lola_small` equal the reference script's
    (`scripts/parity_evidence.py`) digit for digit, and `basic` has no
    row in either;
  * `scripts/torch_keygen_profile.py`: the phases of a small ring's
    parameters, two keygens and the tiny LoLa network's build and prepare;
  * `scripts/torch_run_cryptonets_encrypted.py`: batches of a tiny
    CryptoNets-shaped network (a 4x4 stride-4 conv of the 28x28 images
    with its bias as the last weight,
    Square, Dense(10)) at n = 256, every prediction equal to the Raw
    oracle's.
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cryptonets_tpu_torch.api.factory import CrtBfvFactory, RawFactory  # noqa: E402
from cryptonets_tpu_torch.crypto.primes import ntt_primes  # noqa: E402
from cryptonets_tpu_torch.nn.layers import EncryptLayer, PoolLayer, SquareActivation  # noqa: E402
from cryptonets_tpu_torch.nn.readers import BatchReader  # noqa: E402
from cryptonets_tpu_torch.parallel import dryrun  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_evidence_peak_bits_equal_the_reference_script(monkeypatch):
    ours = _script("torch_parity_evidence")
    theirs = _script("parity_evidence")
    assert ours.REF_BITS == theirs.REF_BITS and ours.ALL == theirs.ALL
    monkeypatch.setattr(sys, "argv", ["parity_evidence.py", "basic", "lola_small"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        theirs.main()
    rows = {line.split()[0]: line.split() for line in out.getvalue().splitlines()[1:]}
    assert "basic" not in rows and ours.peak_bits("basic") is None
    row = ours.peak_bits("lola_small")
    assert rows["lola_small"][1] == str(row["t_bits"])
    assert rows["lola_small"][2] == f"{row['msg_bits']:.2f}"
    assert rows["lola_small"][4] == f"{row['headroom_bits']:.2f}"
    assert row["ref_bits"] == 39.0 and row["msg_bits"] < row["t_bits"] - 1


def test_keygen_profile_phases():
    torch.set_num_threads(1)
    ours = _script("torch_keygen_profile")
    cfg = dict(plain_primes=ntt_primes(256, 17, 2), n=256,
               coeff_modulus=ntt_primes(256, 30, dryrun.TINY_LIMBS + 2), n_special=2)
    res = ours.profile(cfg, torch.device("cpu"),
                       lambda dev: dryrun.build_tiny_lola(device=dev))
    for k in ("params_s", "keygen_1_s", "keygen_2_s", "build_s", "prepare_s"):
        assert res[k] >= 0, k
    # the power-of-two ladder (both signs) and the column key
    ladder = {1 << j for j in range(7)} | {128 - (1 << j) for j in range(7)}
    assert res["galois_keys"] == len(ladder) + 1
    assert res["key_bytes"] > 0 and res["network_galois_keys"] >= res["galois_keys"]


def _tiny_cryptonets(encrypt, batch_size, records, device):
    rng = np.random.default_rng(8)
    fac = (CrtBfvFactory(plain_primes=ntt_primes(256, 29, 2), n=256,
                         coeff_modulus=ntt_primes(256, 30, 5), device=device)
           if encrypt else RawFactory(256))
    reader = BatchReader(RawFactory(256), max_slots=batch_size,
                         normalization_factor=1.0 / 256.0, scale=16.0)
    reader.set_source_records(records)
    enc = EncryptLayer(reader)
    enc.factory = fac
    conv = PoolLayer(enc, input_shape=[28, 28], kernel_shape=[4, 4], stride=[4, 4],
                     map_count=[1, 1], weights=rng.integers(-2, 3, 17).astype(float),
                     weights_scale=4.0)
    dense = PoolLayer(SquareActivation(conv), input_shape=[49], kernel_shape=[49],
                      stride=[1000], map_count=[10],
                      weights=rng.integers(-2, 3, 490).astype(float),
                      bias=rng.integers(-2, 3, 10).astype(float), weights_scale=4.0)
    return dense, fac, reader


def test_run_cryptonets_encrypted_batches_agree_with_the_raw_oracle():
    torch.set_num_threads(1)
    ours = _script("torch_run_cryptonets_encrypted")
    res = ours.run(4, 2, torch.device("cpu"), build=_tiny_cryptonets)
    assert res["graph"] is False        # no graph on the CPU
    assert res["images"] == 8 and res["agreement"] == 8
    assert len(res["batch_s"]) == 2 and res["ms_per_image"] > 0


def test_coeff_noise_helpers_pin_lola_denses_crt_unit():
    """`scripts/torch_coeff_noise.py`: the CRT unit of LoLaDense's first
    plain prime over its output scale 2**61 is the +17.0667 by which
    every logit of its wrong record is off (one unit in that prime's
    constant coefficient)."""
    ours = _script("torch_coeff_noise")
    t1, t2 = 34359771137, 34360754177
    e1, e2 = ours.crt_units((t1, t2))
    assert e1 % t1 == 1 and e1 % t2 == 0 and e2 % t2 == 1 and e2 % t1 == 0
    assert abs(e1 / 2**61 - 17.066666652) < 1e-8
    raw = np.array([-19.587, -5.469, 1.581, -17.560])
    np.testing.assert_allclose(raw + e1 / 2**61, [-2.5203, 11.5977, 18.6477, -0.4933],
                               atol=1e-4)
    assert ours.bits(2**370 + 2**369) == pytest.approx(370 + np.log2(1.5))
