"""`proqa-torch` CLI: the dense-retrieval commands of the `proqa` CLI
(proqa_tpu/cli/main.py), run by the PyTorch port.

Subcommands:
  build-db         jsonl corpus -> sqlite document store
  build-index      corpus -> dense index artifacts (embeddings.npy, idx_id.json)
  encode-queries   questions -> query embedding .npy
  eval-retrieval   recall@k over the index
  retrieve         one-shot question -> top-k paragraphs

Flags and final JSON lines are the `proqa` CLI's, plus `--device` (default
cuda). Checkpoints are `.npz` files in the JAX layout or `.pt` state dicts
(models/convert.py). Flags for paths not ported yet (--stream-chunk,
--dp-encode, --shard-index, --int8-index) raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _bert_cfg(args, flash_default: bool = False):
    import dataclasses

    import torch

    from proqa_tpu_torch.models.bert import BertConfig

    dtype = torch.float32 if getattr(args, "f32", False) else torch.bfloat16
    cfg = BertConfig.tiny(dtype=dtype) if args.tiny else BertConfig(dtype=dtype)
    flash = getattr(args, "flash_attention", None)
    return dataclasses.replace(cfg, flash_attention=flash_default if flash is None else flash)


def _tokenizer(args):
    from proqa_tpu.text.wordpiece import BertTokenizer

    return BertTokenizer.from_vocab_file(args.vocab, do_lower_case=not args.cased)


def _load_model(args, cfg):
    from proqa_tpu_torch.models.convert import load_params
    from proqa_tpu_torch.models.retriever import Retriever

    model = Retriever(cfg)
    model.load_state_dict(load_params(args.init_checkpoint))
    return model.to(args.device).eval()


def _reject_unported(args):
    for flag, item in (("dp_encode", 15), ("shard_index", 15), ("int8_index", 13)):
        if getattr(args, flag, False):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to PyTorch yet "
                f"(ROADMAP Queue 1, item {item})"
            )


def _index_dtype(args):
    import torch

    return torch.float32 if args.f32 else torch.bfloat16


def _add_common(p):
    p.add_argument("--vocab", required=True, help="wordpiece vocab file")
    p.add_argument("--cased", action="store_true")
    p.add_argument("--profile-dir", default="",
                   help="accepted for flag parity with `proqa`; only training reads it")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke tests)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--max-seq-length", type=int, default=512)
    p.add_argument("--max-query-length", type=int, default=30)
    p.add_argument("--flash-attention", action="store_true", default=None,
                   help="fused attention kernel K2 (default on for these commands)")
    p.add_argument("--no-remat", dest="remat", action="store_false", default=True,
                   help="accepted for flag parity with `proqa`; only training reads it")
    p.add_argument("--f32", action="store_true",
                   help="float32 activations + index scoring (parity runs; "
                        "default bf16 is the production path)")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _shard_index_arg(p):
    p.add_argument("--shard-index", action="store_true", help="not ported yet")
    p.add_argument("--int8-index", action="store_true", help="not ported yet")


def cmd_build_index(args):
    from proqa_tpu_torch.index.build import build_index

    _reject_unported(args)
    cfg = _bert_cfg(args, flash_default=True)
    index = build_index(
        _load_model(args, cfg), args.corpus, tokenizer=_tokenizer(args),
        max_length=args.max_seq_length, batch_size=args.predict_batch_size,
        save_path=args.output_dir, dtype=cfg.dtype, stream_chunk=args.stream_chunk,
    )
    print(json.dumps({"rows": len(index), "dim": index.dim, "saved": args.output_dir}))


def cmd_encode_queries(args):
    from proqa_tpu.data.datasets import EncodeDataset
    from proqa_tpu_torch.index.build import encode_corpus

    _reject_unported(args)
    cfg = _bert_cfg(args, flash_default=True)
    ds = EncodeDataset(_tokenizer(args), args.queries,
                       max_query_length=args.max_query_length, is_query=True)
    emb = encode_corpus(_load_model(args, cfg), ds, batch_size=args.predict_batch_size,
                        is_query=True)
    np.save(args.output, emb)
    print(json.dumps({"queries": int(emb.shape[0]), "saved": args.output}))


def cmd_eval_retrieval(args):
    from proqa_tpu.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.recall import evaluate_retrieval

    _reject_unported(args)
    index = DenseIndex.load(args.index, device=args.device, dtype=_index_dtype(args))
    db = DocDB(args.db)
    if args.query_embed.endswith(".npy"):
        q = np.load(args.query_embed)
    else:
        # raw {"question"} jsonl: encode on the fly (needs --vocab/--init-checkpoint)
        if not (args.vocab and args.init_checkpoint):
            raise SystemExit("encoding queries on the fly requires --vocab and --init-checkpoint")
        from proqa_tpu.data.datasets import EncodeDataset
        from proqa_tpu_torch.index.build import encode_corpus

        cfg = _bert_cfg(args, flash_default=True)
        ds = EncodeDataset(_tokenizer(args), args.query_embed,
                           max_query_length=args.max_query_length, is_query=True)
        q = encode_corpus(_load_model(args, cfg), ds, batch_size=256, is_query=True,
                          buckets=None)
    recalls = evaluate_retrieval(args.raw_data, index, q, db, topk=args.topk,
                                 num_workers=args.num_workers)
    for k, v in sorted(recalls.items()):
        print(f"Top {k} Recall: {v:.4f}")
    print(json.dumps({f"recall@{k}": v for k, v in recalls.items()}))


def cmd_retrieve(args):
    """One-shot retrieval: encode a question, search, print the top-k
    paragraphs."""
    import torch

    from proqa_tpu.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex

    _reject_unported(args)
    cfg = _bert_cfg(args, flash_default=True)
    model = _load_model(args, cfg)
    index = DenseIndex.load(args.index, device=args.device, dtype=_index_dtype(args))
    db = DocDB(args.db) if args.db else None

    ids = _tokenizer(args).encode(args.question, max_length=args.max_query_length)
    ids = ids + [0] * (args.max_query_length - len(ids))
    ids_t = torch.tensor([ids], dtype=torch.int64, device=args.device)
    with torch.inference_mode():
        q = model.encode_query(ids_t, (ids_t != 0).to(torch.int32))
    vals, rows = index.search(q, args.topk)  # search casts to the index dtype
    results = []
    for score, row in zip(vals[0], rows[0]):
        rec = {"row": int(row), "score": round(float(score), 4)}
        if index.id_map is not None:
            rec["id"] = index.id_map[int(row)]
            if db is not None:
                text = db.get_doc_text(rec["id"])
                rec["text"] = text[:300] if text else None
        results.append(rec)
    print(json.dumps({"question": args.question, "topk": results}, ensure_ascii=False))


def cmd_build_db(args):
    """{"text", ["id"]} jsonl corpus -> sqlite document store."""
    from proqa_tpu.data.docdb import DocDB

    def rows():
        with open(args.corpus) as f:
            for i, line in enumerate(f):
                if line.strip():
                    row = json.loads(line)
                    yield str(row.get("id", i)), row["text"]

    db = DocDB.create(args.db, rows())
    print(json.dumps({"documents": len(db), "db": args.db}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="proqa-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("build-index")
    _add_common(sp)
    sp.add_argument("--corpus", required=True, help='{"text", ["id"]} jsonl')
    sp.add_argument("--init-checkpoint", required=True, help=".npz (JAX layout) or .pt")
    sp.add_argument("--output-dir", required=True)
    sp.add_argument("--predict-batch-size", type=int, default=512)
    sp.add_argument("--stream-chunk", type=int, default=0, help="not ported yet (must be 0)")
    sp.add_argument("--dp-encode", action="store_true", help="not ported yet")
    sp.set_defaults(fn=cmd_build_index)

    sp = sub.add_parser("encode-queries")
    _add_common(sp)
    sp.add_argument("--queries", required=True, help='{"question"} jsonl')
    sp.add_argument("--init-checkpoint", required=True, help=".npz (JAX layout) or .pt")
    sp.add_argument("--output", required=True, help=".npy path")
    sp.add_argument("--predict-batch-size", type=int, default=512)
    sp.add_argument("--dp-encode", action="store_true", help="not ported yet")
    sp.set_defaults(fn=cmd_encode_queries)

    sp = sub.add_parser("eval-retrieval")
    sp.add_argument("raw_data")
    sp.add_argument("index", help="index dir or embeddings .npy")
    sp.add_argument("query_embed",
                    help="query embeddings .npy, or a {'question'} jsonl to encode on the fly")
    sp.add_argument("db")
    sp.add_argument("--topk", type=int, default=80)
    sp.add_argument("--num-workers", type=int, default=0)
    sp.add_argument("--vocab", default="")
    sp.add_argument("--init-checkpoint", default="")
    sp.add_argument("--cased", action="store_true")
    sp.add_argument("--tiny", action="store_true")
    sp.add_argument("--max-query-length", type=int, default=30)
    sp.add_argument("--f32", action="store_true", help="float32 index scoring (parity runs)")
    _shard_index_arg(sp)
    _add_device(sp)
    sp.set_defaults(fn=cmd_eval_retrieval)

    sp = sub.add_parser("retrieve", help="one-shot question -> top-k paragraphs")
    _add_common(sp)
    sp.add_argument("--question", required=True)
    sp.add_argument("--index", required=True)
    sp.add_argument("--init-checkpoint", required=True, help=".npz (JAX layout) or .pt")
    sp.add_argument("--db", default="", help="sqlite doc store (adds text previews)")
    sp.add_argument("--topk", type=int, default=5)
    _shard_index_arg(sp)
    sp.set_defaults(fn=cmd_retrieve)

    sp = sub.add_parser("build-db")
    sp.add_argument("--corpus", required=True, help='{"text", ["id"]} jsonl')
    sp.add_argument("--db", required=True, help="output sqlite path")
    sp.set_defaults(fn=cmd_build_db)
    return p


def main(argv=None):
    from proqa_tpu_torch.ops.dot import pin_f32_precision

    args = build_parser().parse_args(argv)
    pin_f32_precision()
    try:
        args.fn(args)
    except FileNotFoundError as e:
        # argv is None only on real command-line use; under tests re-raise
        if argv is None:
            sys.exit(f"proqa-torch: file not found: {e.filename or e}\n"
                     f"  (while running '{args.cmd}': check the path arguments)")
        raise


if __name__ == "__main__":
    main()
