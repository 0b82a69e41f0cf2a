"""The card-side kernel tools' text edits still find their anchors.

`utils/kernel_variants.py` builds each dropped design as a copy of a CUDA
source with a few text edits, and `utils/phase_probe.py` inserts clock
stamps before or after named lines of a source.  Both run only on the card,
so an anchor that a later change to the source moved would first fail
there.  These tests apply every edit and every stamp to the sources on the
CPU: each anchor is present, each edit changes the text, and each probe
inserts one stamp per point (and none in another kernel of the file).
"""

import pytest

from whisper_tpu_torch.ops import _cuda
from whisper_tpu_torch.utils import kernel_variants as KV
from whisper_tpu_torch.utils import phase_probe as PP

VARIANTS = [("qmm", KV.QMM_VARIANTS), ("enc_attn", KV.ENC_VARIANTS),
            ("flash_attn", KV.FLASH_VARIANTS), ("flash_attn", KV.FLASH_MMA_VARIANTS),
            ("qmmt", KV.QMMT_VARIANTS), ("qmmt", KV.QMMT_ROWS_VARIANTS)]


def _source(name):
    return (_cuda.CSRC / _cuda.SOURCES[name]).read_text()


@pytest.mark.parametrize("name,variants", VARIANTS,
                         ids=["qmm", "enc_attn", "flash_wgmma", "flash_mma", "qmmt",
                              "qmmt_rows"])
def test_variant_edits_find_their_anchors(name, variants):
    src = _source(name)
    assert variants[0] == ("committed", [])
    for tag, edits in variants:
        s = src
        for old, new in edits:
            assert old in s, (tag, old)
            s = s.replace(old, new, 1)
        assert (s != src) == bool(edits), tag


@pytest.mark.parametrize("name,points,kernel", [("qmmt", PP.K1, None), ("qmmt", PP.K1F, None),
                                                ("qmmt", PP.KR, "qmmt_rows_kernel"),
                                                ("decode_attn", PP.K3, None),
                                                ("flash_attn", PP.K6, "flash_attn_mma_kernel")])
def test_probe_points_find_their_anchors(name, points, kernel):
    out = PP.patch(_source(name), points)
    assert out.count("g_stamps[o_ + 8 + ") == len(points)
    assert out.count("__device__ unsigned long long* g_stamps;") == 1
    if kernel is not None:
        # every stamp lands in the probed kernel, after its definition starts
        assert out.index("g_stamps[o_ + 8 + ") > out.index(f"{kernel}(const")
