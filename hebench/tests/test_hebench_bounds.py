"""The copied bound arithmetic against numbers worked by hand."""

import pytest

from hebench.work import bounds

PEAK_INT32 = 132 * 64 * 1.98e9


def test_peaks():
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.INT32_MUL_PER_S == pytest.approx(1.672704e13)
    assert bounds.INT8_TENSOR_OPS_PER_S == 1.979e15


def test_ntt_bound_forward_is_bytes():
    # 448 rows of n = 8192 over 7 limbs: 2 * 448 * 8192 * 4 data bytes,
    # 2 * 7 * 8192 * 4 table bytes, 7 * 4 moduli bytes
    b = bounds.ntt_bound(448, 8192, 7, inverse=False)
    nbytes = 29360128 + 458752 + 28
    assert b["bytes_ms"] == pytest.approx(1e3 * nbytes / 3.35e12)
    assert b["bound_ms"] == pytest.approx(0.0089012, rel=1e-4)
    assert b["bound_by"] == "bytes"
    # 448 * 4096 * 13 butterflies, two multiplies each
    assert b["ops_ms"] == pytest.approx(1e3 * 2 * 23855104 / PEAK_INT32)


def test_ntt_bound_inverse_adds_the_scaling():
    f = bounds.ntt_bound(448, 8192, 7, inverse=False)
    i = bounds.ntt_bound(448, 8192, 7, inverse=True)
    assert i["bytes_ms"] - f["bytes_ms"] == pytest.approx(1e3 * 56 / 3.35e12)
    assert i["ops_ms"] - f["ops_ms"] == pytest.approx(1e3 * 2 * 448 * 8192 / PEAK_INT32)


def test_contract_bound_is_int8_operations():
    # CryptoNets' Dense(100) over 845 inputs, 3 plain primes, 2 polys, 7
    # limbs: 3 * 100 * 2 * 7 * 8192 outputs of 845 terms
    out = 3 * 100 * 2 * 7 * 8192
    b = bounds.contract_bound(out // 100 * 845, out, 100, 845, 7)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * 32 * out * 845 / 1.979e15)
    assert b["bound_ms"] == pytest.approx(0.4701, rel=1e-3)


def test_fused_bound():
    b = bounds.fused_bound(3_350_000_000, 0, 0)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = bounds.fused_bound(0, PEAK_INT32 / 2 - 10, 10)
    assert b["bound_ms"] == pytest.approx(1e3) and b["bound_by"] == "operations"


def test_distinct_skips_broadcast_dims():
    assert bounds.distinct((4, 3, 5), (15, 0, 1)) == 20
    assert bounds.distinct((4, 3, 5), (15, 5, 1)) == 60


def test_mac_and_bconv_bounds_count_each_operand_once():
    # K6: a [J=2, 1, 1, 1, L=3, N=8], one key [Z=4, J=2, 1, 1, 1, 3, 8] (its
    # size-1 dims of stride 0)
    a = ((2, 1, 1, 1, 3, 8), (24, 24, 24, 24, 8, 1))
    key = ((4, 2, 1, 1, 1, 3, 8), (48, 24, 0, 0, 0, 8, 1))
    b = bounds.mac_bound(a, [key], [None], None, 3)
    outputs = 4 * 1 * 1 * 1 * 1 * 3 * 8
    nbytes = 4 * (48 + 192 + outputs + 12)
    assert b["bytes_ms"] == pytest.approx(1e3 * nbytes / 3.35e12)
    assert b["ops_ms"] == pytest.approx(1e3 * 2 * (outputs * 2 + outputs) / PEAK_INT32)
    # K7: y [1, 2, Lf=7, N=16] to 9 targets, a [7, 9] table
    y = ((1, 2, 7, 16), (224, 112, 16, 1))
    c = bounds.bconv_bound(y, 63, 9)
    outputs = 2 * 9 * 16
    assert c["bytes_ms"] == pytest.approx(1e3 * 4 * (224 + outputs + 36 + 63) / 3.35e12)
    assert c["ops_ms"] == pytest.approx(1e3 * 2 * (outputs * 7 + outputs) / PEAK_INT32)
