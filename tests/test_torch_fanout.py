"""The port's stream fan-out (``codec/wavefront_scan.py::ShardedScanCodec``)
on the CPU, mirroring tests/test_scan_multi.py.

D = 2 and 4 replicas of a B=1 codec (tiny config, random symbol planes,
one replica left idle), in both scan profiles: streams the plain B=1
codec encodes decode on the replicas bit for bit, the replicas' encodes
are byte-identical to the B=1 codec's, and the B=1 codec decodes them.
"""

import numpy as np
import pytest
import torch

from pseudocylindrical_convolution_torch.codec.wavefront_scan import (
    ScanWavefrontCodec, ShardedScanCodec)

import torch_ranks as tr

CFG = tr.CFG
GEOM = CFG.geometry()
H, W = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(n, seed=0):
    rng = np.random.RandomState(seed)
    planes = rng.randint(0, 8, size=(n, GEOM.npart, CFG.ngroup, H, W))
    hindex = GEOM.hindex(H * GEOM.npart, W)
    for g in range(GEOM.npart):
        planes[:, g, :, :, hindex[g]:] = 0
    return planes


@pytest.mark.parametrize("window_mode", ["window", "fused"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_fanout_bit_equal_to_one_stream(ndev, window_mode):
    codec = ScanWavefrontCodec(CFG, GEOM, H, W, batch=1, lanes=8,
                               dtype=torch.float32, device="cpu",
                               window_mode=window_mode).prepare(
                                   tr.model(0).ent)
    sharded = ShardedScanCodec(codec, ["cpu"] * ndev)
    assert all(r.window_mode == window_mode for r in sharded.replicas)
    n = ndev - 1
    planes = _planes(n, seed=ndev)
    streams = [codec.encode_planes(planes[i:i + 1])[0] for i in range(n)]
    np.testing.assert_array_equal(sharded.decode_streams(streams), planes)
    streams2 = sharded.encode_planes(planes)
    assert len(streams2) == n
    for (p1, n1), (p2, n2) in zip(streams, streams2):
        assert p1 == p2
        np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(codec.decode_streams([streams2[-1]])[0],
                                  planes[-1])
    with pytest.raises(ValueError):
        sharded.decode_streams(streams + streams[:1] * 2)
