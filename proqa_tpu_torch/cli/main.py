"""`proqa-torch` CLI: the retriever-pretraining and dense-retrieval commands
of the `proqa` CLI (proqa_tpu/cli/main.py), run by the PyTorch port.

Subcommands:
  pretrain-retriever   contrastive bi-encoder pretraining
  build-db             jsonl corpus -> sqlite document store
  build-index          corpus -> dense index artifacts (embeddings.npy, idx_id.json)
  encode-queries       questions -> query embedding .npy
  eval-retrieval       recall@k over the index
  retrieve             one-shot question -> top-k paragraphs

Flags and final JSON lines are the `proqa` CLI's, plus `--device` (default
cuda). Checkpoints are `.npz` files in the JAX layout, `.pt` state dicts, or
the `.pt` train checkpoints pretrain-retriever writes (models/convert.py).
Flags for paths not ported yet (--stream-chunk, --dp-encode, --shard-index,
--int8-index) raise NotImplementedError.
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
    return dataclasses.replace(cfg, flash_attention=flash_default if flash is None else flash,
                               remat=getattr(args, "remat", True))


def _tokenizer(args):
    from proqa_tpu_torch.text.wordpiece import BertTokenizer

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
                   help="torch.profiler trace of a few warm train steps into this directory "
                        "(pretrain-retriever)")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke tests)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--max-seq-length", type=int, default=512)
    p.add_argument("--max-query-length", type=int, default=30)
    p.add_argument("--flash-attention", action="store_true", default=None,
                   help="fused attention kernels K2/K3 (default on for these commands)")
    p.add_argument("--no-remat", dest="remat", action="store_false", default=True,
                   help="keep every layer's activations for backward (training only)")
    p.add_argument("--f32", action="store_true",
                   help="float32 activations + index scoring (parity runs; "
                        "default bf16 is the production path)")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _shard_index_arg(p):
    p.add_argument("--shard-index", action="store_true", help="not ported yet")
    p.add_argument("--int8-index", action="store_true", help="not ported yet")


def cmd_pretrain_retriever(args):
    import os
    import random

    from proqa_tpu_torch.data.datasets import (
        ClusterPairDataset, PairDataset, cluster_batch_order, grouped_shuffle_order,
    )
    from proqa_tpu_torch.data.loader import BatchLoader
    from proqa_tpu_torch.models.convert import load_params
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer, RetrieverTrainerConfig

    cfg = _bert_cfg(args, flash_default=True)
    tok = _tokenizer(args)
    tcfg = RetrieverTrainerConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        adam_eps=args.adam_eps,
        accumulate_gradients=args.accumulate_gradients,
        num_train_epochs=args.num_train_epochs,
        eval_period=args.eval_period,
        save_checkpoints_steps=args.save_checkpoints_steps,
        wait_step=args.wait_step,
        warmup_steps=args.warmup_steps,
        seed=args.seed,
        output_dir=args.output_dir,
        profile_dir=args.profile_dir,
    )
    params = load_params(args.init_checkpoint) if args.init_checkpoint else None
    trainer = RetrieverTrainer(cfg, tcfg, params=params, device=args.device)
    if args.resume:
        trainer.resume(args.resume)

    is_cluster = os.path.isdir(args.train_file)
    dataset = ClusterPairDataset if is_cluster else PairDataset
    train_ds = dataset(tok, args.train_file, args.max_query_length, args.max_seq_length,
                       args.filter)
    eval_ds = PairDataset(tok, args.predict_file, args.max_query_length, args.max_seq_length)

    def train_batches(epoch):
        rng = random.Random(args.seed + epoch)
        order = (cluster_batch_order(train_ds, args.train_batch_size, rng)
                 if is_cluster else grouped_shuffle_order(train_ds, rng))
        return BatchLoader(
            train_ds.batches(order, args.train_batch_size, drop_last=True), prefetch=4)

    def eval_batches():
        return BatchLoader(
            eval_ds.batches(list(range(len(eval_ds))), args.predict_batch_size), prefetch=4)

    best = trainer.train(train_batches, eval_batches)
    print(json.dumps({"best_in_batch_acc": best}))


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
    from proqa_tpu_torch.data.datasets import EncodeDataset
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
    from proqa_tpu_torch.data.docdb import DocDB
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
        from proqa_tpu_torch.data.datasets import EncodeDataset
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

    from proqa_tpu_torch.data.docdb import DocDB
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
    from proqa_tpu_torch.data.docdb import DocDB

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

    sp = sub.add_parser("pretrain-retriever")
    _add_common(sp)
    sp.add_argument("--train-file", required=True, help="pairs jsonl or cluster-shard dir")
    sp.add_argument("--predict-file", required=True)
    sp.add_argument("--output-dir", default="logs/retriever")
    sp.add_argument("--init-checkpoint", default="", help=".npz (JAX layout) or .pt")
    sp.add_argument("--resume", default="", help="a checkpoint_*.pt of an earlier run")
    sp.add_argument("--train-batch-size", type=int, default=80)
    sp.add_argument("--predict-batch-size", type=int, default=100)
    sp.add_argument("--learning-rate", type=float, default=1e-5)
    sp.add_argument("--weight-decay", type=float, default=0.0)
    sp.add_argument("--max-grad-norm", type=float, default=5.0)
    sp.add_argument("--adam-eps", type=float, default=1e-8)
    sp.add_argument("--accumulate-gradients", type=int, default=1)
    sp.add_argument("--num-train-epochs", type=int, default=100)
    sp.add_argument("--eval-period", type=int, default=2500,
                    help="steps between dev evals; <=0: epoch end only")
    sp.add_argument("--save-checkpoints-steps", type=int, default=20000,
                    help="steps between numbered checkpoints; <=0: none")
    sp.add_argument("--wait-step", type=int, default=100)
    sp.add_argument("--warmup-steps", type=int, default=0)
    sp.add_argument("--filter", action="store_true")
    sp.set_defaults(fn=cmd_pretrain_retriever)

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
