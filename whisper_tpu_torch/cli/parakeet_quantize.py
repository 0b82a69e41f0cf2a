"""parakeet-quantize: re-encode a Parakeet ggml model file.

Mirror of examples/parakeet-quantize: byte-copies the Parakeet header
(hparams + filters + window + tdt durations + vocab) rewriting ftype, then
streams tensor records through the shared quantizer.  Skip-list per the
reference (:154-180): depthwise-conv weights and pos_bias tensors stay f32;
prediction/joint tensors stay f32 when n_pred_dim is not divisible by the
quant block size.

Usage: python -m whisper_tpu.cli.parakeet_quantize in.bin out.bin q5_0
"""

from __future__ import annotations

import argparse
import sys
from typing import BinaryIO

from ..formats import container, quants, requant


def copy_parakeet_header(fin: BinaryIO, fout: BinaryIO,
                         ftype_dst: int) -> dict:
    container.check_magic(fin)
    container.write_i32(fout, container.GGML_FILE_MAGIC)
    hparams = [container.read_i32(fin) for _ in range(15)]
    out = list(hparams)
    out[6] = (quants.GGML_QNT_VERSION * quants.GGML_QNT_VERSION_FACTOR
              + ftype_dst)  # ftype slot
    for v in out:
        container.write_i32(fout, v)

    n_mel = container.read_i32(fin)
    n_fb = container.read_i32(fin)
    container.write_i32(fout, n_mel)
    container.write_i32(fout, n_fb)
    fout.write(fin.read(4 * n_mel * n_fb))

    n_window = container.read_i32(fin)
    container.write_i32(fout, n_window)
    fout.write(fin.read(4 * n_window))

    n_tdt = hparams[13]
    fout.write(fin.read(4 * n_tdt))

    n_vocab = container.read_i32(fin)
    container.write_i32(fout, n_vocab)
    for _ in range(n_vocab):
        n = container.read_i32(fin)
        container.write_i32(fout, n)
        fout.write(fin.read(n))
    return {"n_pred_dim": hparams[11]}


def quantize_parakeet(fname_inp: str, fname_out: str, ftype: int,
                      verbose: bool = True) -> requant.QuantizeReport:
    qtype = quants.FTYPE_TO_QTYPE[ftype]
    with open(fname_inp, "rb") as fin, open(fname_out, "wb") as fout:
        hp = copy_parakeet_header(fin, fout, ftype)
        skip = [
            r"encoder\.layers\..+\.conv\.depthwise_conv\.weight",
            r"encoder\.layers\..+\.self_attn\.pos_bias_u",
            r"encoder\.layers\..+\.self_attn\.pos_bias_v",
        ]
        blck = quants.SPECS[qtype].block_elems
        if blck > 1 and hp["n_pred_dim"] % blck != 0:
            skip += [
                r"decoder\.prediction\.embed\.weight",
                r"decoder\.prediction\.dec_rnn\.lstm\.weight_ih_l.*",
                r"decoder\.prediction\.dec_rnn\.lstm\.weight_hh_l.*",
                r"joint\.pred\.weight",
                r"joint\.joint_net\.2\.weight",
            ]
        rep = requant.quantize_tensor_stream(fin, fout, qtype, [".*"], skip,
                                             verbose=verbose)
    if verbose:
        print(f"model size  = {rep.total_size_org / 1e6:8.2f} MB")
        print(f"quant size  = {rep.total_size_new / 1e6:8.2f} MB")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parakeet-quantize")
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("ftype")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    try:
        ftype = requant.parse_ftype(args.ftype)
        quantize_parakeet(args.model_in, args.model_out, ftype,
                          verbose=not args.quiet)
    except (ValueError, NotImplementedError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
