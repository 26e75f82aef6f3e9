"""The port's safetensors reader and writer (stable_diffusion_tpu_torch/
utils/safetensors_io.py) against the ``safetensors`` package the JAX
converter reads with: round trips in both directions for every dtype (BF16
handed on as bfloat16, not through f16), and files whose header lies about
their data raise."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from stable_diffusion_tpu_torch.utils import safetensors_io as S
from tests.torch_threads import one_thread  # noqa: F401

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int8,
          torch.uint8, torch.bool]


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, shape in (("a.weight", (3, 5)), ("b", (7,)), ("c.scalar", ()), ("d.empty", (0, 4)),
                        ("e.conv", (2, 3, 3, 3))):
        x = torch.randn(shape, generator=g) * 100
        out[name] = x > 0 if dtype == torch.bool else x.to(dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ours_read_by_safetensors(tmp_path, dtype):
    ts = _tensors(dtype)
    path = str(tmp_path / "ours.safetensors")
    S.save_file(ts, path, metadata={"format": "pt"})
    back = st_load(path)
    assert sorted(back) == sorted(ts)
    for k, v in ts.items():
        assert back[k].dtype == dtype and back[k].shape == v.shape and torch.equal(back[k], v), k
    with safe_open(path, framework="np") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_read_by_ours(tmp_path, dtype):
    ts = _tensors(dtype)
    path = str(tmp_path / "theirs.safetensors")
    st_save(ts, path, metadata={"format": "pt"})
    back = S.load_file(path)
    assert sorted(back) == sorted(ts)
    for k, v in ts.items():
        assert back[k].dtype == dtype and back[k].shape == v.shape and torch.equal(back[k], v), k


def test_mixed_dtypes_and_numpy_inputs(tmp_path):
    ts = {"w": torch.randn(4, 4).half(), "ids": np.arange(77)[None], "s": torch.randn(3).bfloat16(),
          "f": np.ones((2, 2), np.float32)}
    path = str(tmp_path / "mixed.safetensors")
    S.save_file(ts, path)
    theirs, ours = st_load(path), S.load_file(path)
    for k in ts:
        want = torch.from_numpy(ts[k]) if isinstance(ts[k], np.ndarray) else ts[k]
        assert torch.equal(theirs[k], want) and torch.equal(ours[k], want), k
    header, start = S.read_header(path)
    assert start % 8 == 0  # the header padded to 8 bytes
    for info in header.values():  # every tensor at a multiple of its item size
        size = np.dtype({"F16": np.float16, "BF16": np.uint16, "I64": np.int64,
                         "F32": np.float32}[info["dtype"]]).itemsize
        assert info["data_offsets"][0] % size == 0


def test_only_empty_tensors(tmp_path):
    path = str(tmp_path / "empty.safetensors")
    st_save({"e": torch.zeros(0, 3)}, path)
    back = S.load_file(path)
    assert back["e"].shape == (0, 3) and back["e"].dtype == torch.float32


def test_bf16_bits_survive(tmp_path):
    """Every bf16 bit pattern that is a number, read back bit for bit (an
    f16 detour would lose the range and the low bits)."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    path = str(tmp_path / "bf16.safetensors")
    S.save_file({"x": x}, path)
    back = S.load_file(path)["x"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    assert torch.equal(st_load(path)["x"].view(torch.int16), x.view(torch.int16))


def _rewrite_header(path, edit):
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    edit(header)
    blob = json.dumps(header).encode()
    open(path, "wb").write(struct.pack("<Q", len(blob)) + blob + raw[8 + n:])


@pytest.mark.parametrize("corrupt", ["past_the_end", "wrong_length", "reversed", "dtype"])
def test_a_lying_header_raises(tmp_path, corrupt):
    path = str(tmp_path / "bad.safetensors")
    S.save_file({"a": torch.randn(4, 4), "b": torch.randn(3)}, path)

    def edit(h):
        if corrupt == "past_the_end":
            h["b"]["data_offsets"] = [64, 64 + 12 + 1000]
            h["b"]["shape"] = [253]
        elif corrupt == "wrong_length":
            h["a"]["shape"] = [4, 5]
        elif corrupt == "reversed":
            h["a"]["data_offsets"] = h["a"]["data_offsets"][::-1]
        else:
            h["a"]["dtype"] = "F8_E4M3X"

    _rewrite_header(path, edit)
    with pytest.raises(ValueError, match="unknown dtype" if corrupt == "dtype" else "offsets"):
        S.load_file(path)


def test_a_truncated_file_raises(tmp_path):
    path = tmp_path / "short.safetensors"
    path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(ValueError, match="runs past"):
        S.load_file(str(path))
    path.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too short"):
        S.load_file(str(path))
