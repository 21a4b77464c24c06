"""The port's bench tools (repurpose_tpu_torch.tools) against the repository's
root ``tools/bench_attention_fwd.py`` and ``tools/bench_int8_matmul.py`` on
the CPU: the plain versions of the three kernels against the tools' Pallas
kernels in interpret mode, on the same numpy inputs, and both tools' ``main``
at shrunken sizes.

Tolerances:
- ``mha_nt`` against ``mha_pallas_nt``, every row (past the last valid key
  and fully masked rows included): float32 atol 1e-5 (both sum in float32;
  measured 4e-7); bf16 1e-2 of max |out| (the bf16 outputs and the bf16
  exponentials fed to the PV product round at the same points, but XLA and
  PyTorch sum in other orders, so a value may land one bf16 ulp, 2**-8
  relative, away; measured 1e-3 against a max of 1.2).
- ``mha_nt`` against the port's ``mha_torch``: float32 atol 1e-5 (scale
  applied to q or to the scores: ~1e-6); bf16 1e-2 of max |out| (``mha_torch``
  neither rounds the scaled q nor the exponentials to bf16, only the
  normalised weights).
- ``int8_matmul`` and ``int8_core``: bit for bit.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops.attention import mha_torch
from repurpose_tpu_torch.tools import bench_attention_fwd as port_attn
from repurpose_tpu_torch.tools import bench_int8_matmul as port_int8

ROOT = Path(__file__).resolve().parent.parent
B, T, H, DH = 3, 256, 4, 32


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_attn():
    return _load_tool("bench_attention_fwd")


@pytest.fixture(scope="module")
def jax_int8():
    return _load_tool("bench_int8_matmul")


def _attention_inputs(dtype):
    """q/k/v [3, 256, 4 * 32] rounded to ``dtype`` (numpy float32 copies) and
    key_valid: row 0 ragged (200 keys) with interior holes, row 1 fully
    masked, row 2 with its first 37 keys masked and a ragged end."""
    rng = np.random.default_rng(5)
    qkv = [jnp.asarray(rng.normal(0, 1, (B, T, H * DH)).astype(np.float32)).astype(dtype)
           for _ in range(3)]
    valid = np.ones((B, T), bool)
    valid[0, 200:] = False
    valid[0, rng.integers(0, 200, 20)] = False
    valid[1] = False
    valid[2, :37] = False
    valid[2, 150:] = False
    return qkv, valid


def _torch(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _assert_close_attention(got: np.ndarray, want: np.ndarray, torch_dtype) -> None:
    if torch_dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("d_block", [32, 64, 128])
@pytest.mark.parametrize("jax_dtype,torch_dtype", DTYPES, ids=["float32", "bfloat16"])
def test_mha_nt_matches_pallas_nt_on_every_row(jax_attn, d_block, jax_dtype, torch_dtype):
    (q, k, v), valid = _attention_inputs(jax_dtype)
    want = jax_attn.mha_pallas_nt(q, k, v, jnp.asarray(valid), heads=H, q_block=64,
                                  d_block=d_block, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = port_attn.mha_nt(*(_torch(x, torch_dtype) for x in (q, k, v)),
                           torch.from_numpy(valid), heads=H, heads_per_block=d_block // DH)
    assert got.dtype == torch_dtype and got.shape == (B, T, H * DH)
    _assert_close_attention(got.float().numpy(), want, torch_dtype)
    assert np.abs(want[1]).max() > 0.05  # the fully masked row averages v over every key


@pytest.mark.parametrize("jax_dtype,torch_dtype", DTYPES, ids=["float32", "bfloat16"])
def test_mha_nt_matches_mha_torch(jax_dtype, torch_dtype):
    (q, k, v), valid = _attention_inputs(jax_dtype)
    qt, kt, vt = (_torch(x, torch_dtype) for x in (q, k, v))
    kv = torch.from_numpy(valid)
    got = port_attn.mha_nt(qt, kt, vt, kv, heads=H)
    want = mha_torch(*(x.view(B, T, H, DH) for x in (qt, kt, vt)), kv).reshape(B, T, H * DH)
    _assert_close_attention(got.float().numpy(), want.float().numpy(), torch_dtype)


def test_mha_nt_raises_on_heads_per_block_the_kernel_lacks():
    (q, k, v), valid = _attention_inputs(jnp.float32)
    qt, kt, vt = (_torch(x, torch.float32) for x in (q, k, v))
    kv = torch.from_numpy(valid)
    for hpb in (3, 8):  # not instantiated
        with pytest.raises(ValueError, match="heads_per_block"):
            port_attn.mha_nt(qt, kt, vt, kv, heads=H, heads_per_block=hpb)
    wide = torch.zeros(1, 64, 4 * 128)  # 4 heads of 128: a group of 512 columns
    with pytest.raises(ValueError, match="heads_per_block"):
        port_attn.mha_nt(wide, wide, wide, torch.ones(1, 64, dtype=torch.bool), heads=4,
                         heads_per_block=4)
    before = port_attn.mha_nt.launches
    port_attn.mha_nt(qt, kt, vt, kv, heads=H, heads_per_block=4)
    assert port_attn.mha_nt.launches == before  # the plain CPU path does not count


def _int8_inputs(m, k, n, seed=0):
    """x [m, k] float32 with an all-zero row; wq, ws from a numpy draw,
    quantised per column as the TPU tool does."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    x[3] = 0.0  # the 1e-12 scale clamp
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    wq, ws = port_int8.quantize_columns(torch.from_numpy(w))
    return x, wq, ws


@pytest.mark.parametrize("m,k,n", [(256, 512, 512), (128, 2048, 256)])
@pytest.mark.parametrize("jax_dtype,torch_dtype", DTYPES, ids=["float32", "bfloat16"])
def test_int8_matmul_equals_pallas_bit_for_bit(jax_int8, m, k, n, jax_dtype, torch_dtype):
    x, wq, ws = _int8_inputs(m, k, n)
    xj = jnp.asarray(x).astype(jax_dtype)
    want = jax_int8.pallas_int8_matmul(xj, jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()),
                                       bm=128, interpret=True)
    got = port_int8.int8_matmul(_torch(xj, torch_dtype), wq, ws)
    assert got.dtype == torch_dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert not got[3].any()


@pytest.mark.parametrize("kind", ["random", "all_127"])
def test_int8_core_equals_pallas_exactly(jax_int8, kind):
    m, k, n = 256, 2048, 256
    if kind == "random":
        rng = np.random.default_rng(1)
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
        wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:  # |acc| = 2048 * 127**2 in every element: past 2**24, inside int32
        xq = np.full((m, k), 127, np.int8)
        xq[1::2] = -127
        wq = np.full((k, n), -127, np.int8)
        wq[:, ::3] = 127
    want = np.asarray(jax_int8.pallas_int8_core(jnp.asarray(xq), jnp.asarray(wq), bm=128,
                                                interpret=True))
    got = port_int8.int8_core(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rows_rounding_points():
    """xs = max|x| times the float32 reciprocal of 127 (not a division by 127),
    then a true division and ties to even."""
    a = np.float32(1.9694248)  # a max |x| where the two differ by one ulp
    inv = np.float32(1.0) / np.float32(127.0)
    x = torch.tensor([[a, 0.5, -1.0, 0.25], [254.0, 5.0, 7.0, -1.0], [0.0] * 4])
    xq, xs = port_int8.quantize_rows(x)
    assert xs[0, 0].item() == a * inv and a * inv != a / np.float32(127.0)
    assert xs[1, 0].item() == 2.0 and xs[2, 0].item() == np.float32(1e-12)
    assert xq.dtype == torch.int8
    assert xq[1].tolist() == [127, 2, 4, 0]  # 2.5 -> 2, 3.5 -> 4, -0.5 -> 0: ties to even
    assert xq[0].tolist() == torch.round(x[0] / xs[0]).tolist() and not xq[2].any()


def test_attention_tool_main_on_cpu(monkeypatch, capsys):
    for name, value in dict(B=2, T=128, H=4, DH=32, N_CHAIN=1, KEYS_VALID=100).items():
        monkeypatch.setattr(port_attn, name, value)
    assert port_attn.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("nt-vs-current")
    assert float(lines[1].rsplit(":", 1)[1]) < 1e-2
    assert [ln.split()[0] for ln in lines[2:]] == [
        "mha_torch:", "flash_forward:", "no-transpose", "no-transpose", "no-transpose",
        "current"]


def test_int8_tool_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(port_int8, "SHAPES", [(64, 128, 64), (40, 64, 96)])
    monkeypatch.setattr(port_int8, "N_CHAIN", 1)
    assert port_int8.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and len(lines) == 5
    for head, err in zip(lines[1::2], lines[2::2]):
        assert head.startswith("[") and "int8-core" in head and "int8-fused" in head
        assert float(err.rsplit(":", 1)[1]) < 0.05


@pytest.mark.parametrize("dtype,dh,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 32, False), (torch.bfloat16, 128, False),
    (torch.float32, 64, False),
])
def test_the_tensor_core_nt_kernel_takes_bf16_at_dh_64(dtype, dh, tc):
    """On CUDA tensors ``mha_nt`` launches the tensor-core kernel
    (``flash_fwd_nt_tc``) for bf16 at Dh 64, at every heads-per-block;
    float32 and the other head widths keep the first kernel."""
    assert port_attn.nt_tc(torch.zeros(1, 4, 8 * dh, dtype=dtype), 8) is tc


def test_mha_nt_on_cpu_tensors_at_the_tensor_core_shape_is_the_plain_version():
    """bf16 at Dh 64 on CPU tensors: ``mha_nt`` is ``mha_nt_reference`` bit for
    bit at each heads-per-block and counts no launch of either kernel."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 130, 4 * 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    kv = torch.ones((2, 130), dtype=torch.bool)
    kv[0, 100:] = False
    kv[1] = False
    before = (port_attn.mha_nt.launches, port_attn.flash_fwd_nt_tc.launches)
    want = port_attn.mha_nt_reference(q, k, v, kv, 4)
    for hpb in port_attn.NT_HEADS_PER_BLOCK:
        assert torch.equal(port_attn.mha_nt(q, k, v, kv, heads=4, heads_per_block=hpb), want)
    assert (port_attn.mha_nt.launches, port_attn.flash_fwd_nt_tc.launches) == before
