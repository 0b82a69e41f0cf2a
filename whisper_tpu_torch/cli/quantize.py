"""whisper-quantize: re-encode a legacy ggml whisper model file.

TPU-native analogue of `examples/quantize/quantize.cpp`: streams the input
model, re-quantizes eligible 2-D f16/f32 tensors to the requested ftype and
byte-copies everything else.  Skip-list = conv biases + positional embeddings
(quantize.cpp:161-168).

Usage: python -m whisper_tpu.cli.quantize model-f16.bin model-q5_0.bin q5_0
"""

from __future__ import annotations

import argparse
import sys
import time

from ..formats import quants, requant
from ..models.whisper.writer import QUANTIZE_SKIP


def quantize_model(fname_inp: str, fname_out: str, ftype: int,
                   verbose: bool = True,
                   imatrix: "dict | None" = None) -> requant.QuantizeReport:
    qtype = quants.FTYPE_TO_QTYPE[ftype]
    with open(fname_inp, "rb") as fin, open(fname_out, "wb") as fout:
        requant.copy_whisper_header(fin, fout, ftype)
        rep = requant.quantize_tensor_stream(
            fin, fout, qtype,
            include=[".*"],
            skip=[s.replace(".", r"\.") for s in sorted(QUANTIZE_SKIP)],
            verbose=verbose, imatrix=imatrix)
    if verbose:
        print(f"model size  = {rep.total_size_org / 1e6:8.2f} MB")
        print(f"quant size  = {rep.total_size_new / 1e6:8.2f} MB | "
              f"ftype = {ftype} ({quants.type_name(qtype)})")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="whisper-quantize",
        description="quantize a legacy ggml whisper model file")
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("ftype", help="target type: q4_0 q4_1 q5_0 q5_1 q8_0 "
                                  "q2_k..q6_k iq4_nl iq4_xs mxfp4 nvfp4 "
                                  "iq1_s iq1_m iq2_xxs iq2_xs iq2_s iq3_xxs "
                                  "iq3_s or a numeric ggml ftype")
    ap.add_argument("--imatrix", default=None,
                    help="importance matrix file (tools/make_imatrix.py) — "
                         "required for the iq1/iq2/iq3 grid types")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    try:
        imatrix = None
        if args.imatrix:
            from ..formats.imatrix import load_imatrix

            imatrix = load_imatrix(args.imatrix)
        ftype = requant.parse_ftype(args.ftype)
        quantize_model(args.model_in, args.model_out, ftype,
                       verbose=not args.quiet, imatrix=imatrix)
    except (ValueError, NotImplementedError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"total time = {(time.perf_counter() - t0) * 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
