"""Stream re-quantization of legacy ggml model files.

TPU-native analogue of `ggml_common_quantize_0`
(reference: examples/common-ggml.cpp:41-246) and the whisper/parakeet
quantize tools (examples/quantize/quantize.cpp, examples/parakeet-quantize).
Operates record-by-record so arbitrarily large models stream through in
O(one tensor) memory.

Rules (matching the reference exactly):
  * a tensor is re-quantized iff its name full-matches one of `include`
    regexes, full-matches none of the `skip` regexes, AND is 2-D;
  * only F32/F16 source tensors may be quantized (error otherwise);
  * everything else is byte-copied unchanged;
  * rows are quantized independently (block layouts never straddle rows).
"""

from __future__ import annotations

import re

import numpy as np
from dataclasses import dataclass, field
from typing import BinaryIO, List, Sequence

from . import container, quants


@dataclass
class QuantizeReport:
    """Size accounting printed by the reference tool."""

    total_size_org: int = 0
    total_size_new: int = 0
    n_quantized: int = 0
    n_copied: int = 0
    per_tensor: List[str] = field(default_factory=list)


def parse_ftype(s: str) -> int:
    """`ggml_parse_ftype` analogue: accept a numeric ftype or a type name
    like 'q5_0' (reference: ggml/src/ggml.c ggml_parse_ftype)."""
    s = s.strip().lower()
    if s.lstrip("-").isdigit():
        ftype = int(s)
        if ftype not in quants.FTYPE_TO_QTYPE:
            raise ValueError(f"unknown ftype {ftype}")
        return ftype
    names = {
        "f32": quants.GGML_FTYPE_ALL_F32,
        "f16": quants.GGML_FTYPE_MOSTLY_F16,
        "q4_0": quants.GGML_FTYPE_MOSTLY_Q4_0,
        "q4_1": quants.GGML_FTYPE_MOSTLY_Q4_1,
        "q5_0": quants.GGML_FTYPE_MOSTLY_Q5_0,
        "q5_1": quants.GGML_FTYPE_MOSTLY_Q5_1,
        "q8_0": quants.GGML_FTYPE_MOSTLY_Q8_0,
        "q2_k": quants.GGML_FTYPE_MOSTLY_Q2_K,
        "q3_k": quants.GGML_FTYPE_MOSTLY_Q3_K,
        "q4_k": quants.GGML_FTYPE_MOSTLY_Q4_K,
        "q5_k": quants.GGML_FTYPE_MOSTLY_Q5_K,
        "q6_k": quants.GGML_FTYPE_MOSTLY_Q6_K,
        "iq4_nl": quants.GGML_FTYPE_MOSTLY_IQ4_NL,
        "iq4_xs": quants.GGML_FTYPE_MOSTLY_IQ4_XS,
        "mxfp4": quants.GGML_FTYPE_MOSTLY_MXFP4,
        "nvfp4": quants.GGML_FTYPE_MOSTLY_NVFP4,
        "iq2_xxs": quants.GGML_FTYPE_MOSTLY_IQ2_XXS,
        "iq2_xs": quants.GGML_FTYPE_MOSTLY_IQ2_XS,
        "iq2_s": quants.GGML_FTYPE_MOSTLY_IQ2_S,
        "iq3_xxs": quants.GGML_FTYPE_MOSTLY_IQ3_XXS,
        "iq3_s": quants.GGML_FTYPE_MOSTLY_IQ3_S,
        "iq1_s": quants.GGML_FTYPE_MOSTLY_IQ1_S,
        "iq1_m": quants.GGML_FTYPE_MOSTLY_IQ1_M,
    }
    if s not in names:
        raise ValueError(f"unknown ftype '{s}' (expected one of {sorted(names)})")
    return names[s]


def quantize_tensor_stream(
    fin: BinaryIO,
    fout: BinaryIO,
    qtype: int,
    include: Sequence[str] = (".*",),
    skip: Sequence[str] = (),
    verbose: bool = False,
    imatrix: "dict | None" = None,
) -> QuantizeReport:
    """Re-encode the tensor-record tail of a legacy ggml file.

    `fin` must be positioned at the first tensor record (header already
    copied by the caller); records stream to `fout` until EOF.

    `imatrix`: {tensor name -> per-column importance values} from
    tools/make_imatrix.py — REQUIRED for the IQ1/IQ2/IQ3 grid types.
    """
    needs_imatrix = qtype in quants._IMATRIX_QUANTIZERS
    if needs_imatrix:
        if imatrix is None:
            raise NotImplementedError(
                f"quantization to {quants.type_name(qtype)} requires an "
                "importance matrix (--imatrix, tools/make_imatrix.py)")
    elif qtype not in quants.supported_quant_types():
        raise NotImplementedError(
            f"quantization to {quants.type_name(qtype)} is not supported")

    inc_re = [re.compile(p) for p in include]
    skip_re = [re.compile(p) for p in skip]
    rep = QuantizeReport()

    for rec in container.read_tensor_records(fin):
        do_q = any(r.fullmatch(rec.name) for r in inc_re)
        if any(r.fullmatch(rec.name) for r in skip_re):
            do_q = False
        # quantize only 2-D tensors (examples/common-ggml.cpp:143)
        do_q = do_q and len(rec.shape) == 2

        if do_q:
            if rec.ggml_type not in (quants.GGML_TYPE_F32, quants.GGML_TYPE_F16):
                raise ValueError(
                    f"unsupported source type {quants.type_name(rec.ggml_type)} "
                    f"for tensor '{rec.name}'")
            blck = quants.SPECS[qtype].block_elems
            if rec.shape[-1] % blck != 0:
                # rows must hold whole blocks (ggml_quantize_chunk asserts
                # n_per_row % block_size == 0)
                raise ValueError(
                    f"tensor '{rec.name}' row size {rec.shape[-1]} is not "
                    f"divisible by {quants.type_name(qtype)} block size {blck}")
            data = rec.to_f32()
            im = None
            if needs_imatrix:
                im = imatrix.get(rec.name)
                if im is None:
                    raise ValueError(
                        f"imatrix has no entry for tensor '{rec.name}' "
                        f"(needed for {quants.type_name(qtype)})")
                im = np.asarray(im, np.float32)
                if im.size != rec.shape[-1]:
                    raise ValueError(
                        f"imatrix entry for '{rec.name}' has {im.size} "
                        f"values, expected {rec.shape[-1]}")
            raw = quants.quantize(data.reshape(rec.shape), qtype, imatrix=im)
            container.write_tensor_record(
                fout, rec.name, raw=raw, ggml_type=qtype, shape=rec.shape)
            rep.n_quantized += 1
            rep.total_size_new += len(raw)
            rep.per_tensor.append(
                f"{rec.name:48s} {str(rec.shape):>18s} f -> "
                f"{quants.type_name(qtype)}  "
                f"{rec.nbytes / 1e6:8.2f} MB -> {len(raw) / 1e6:8.2f} MB")
        else:
            container.write_tensor_record(
                fout, rec.name, raw=rec.data, ggml_type=rec.ggml_type,
                shape=rec.shape)
            rep.n_copied += 1
            rep.total_size_new += rec.nbytes
            rep.per_tensor.append(
                f"{rec.name:48s} {str(rec.shape):>18s} "
                f"{quants.type_name(rec.ggml_type)} (copied) "
                f"{rec.nbytes / 1e6:8.2f} MB")
        rep.total_size_org += rec.n_elems * 4
        if verbose:
            print(rep.per_tensor[-1])
    return rep


def copy_whisper_header(fin: BinaryIO, fout: BinaryIO, ftype_dst: int) -> None:
    """Byte-copy the whisper header (hparams + mel filters + vocab),
    rewriting the ftype field (examples/quantize/quantize.cpp:70-158).

    Leaves `fin` positioned at the first tensor record.
    """
    container.check_magic(fin)
    container.write_i32(fout, container.GGML_FILE_MAGIC)
    hparams = [container.read_i32(fin) for _ in range(11)]
    hparams[10] = quants.GGML_QNT_VERSION * quants.GGML_QNT_VERSION_FACTOR + ftype_dst
    for v in hparams:
        container.write_i32(fout, v)

    n_mel = container.read_i32(fin)
    n_fft = container.read_i32(fin)
    container.write_i32(fout, n_mel)
    container.write_i32(fout, n_fft)
    fout.write(fin.read(4 * n_mel * n_fft))

    n_vocab = container.read_i32(fin)
    container.write_i32(fout, n_vocab)
    for _ in range(n_vocab):
        n = container.read_i32(fin)
        container.write_i32(fout, n)
        fout.write(fin.read(n))
