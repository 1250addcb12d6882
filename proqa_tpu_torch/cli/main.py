"""`proqa-torch` CLI: every command of the `proqa` CLI
(proqa_tpu/cli/main.py), run by the PyTorch port.

Subcommands:
  pretrain-retriever   contrastive bi-encoder pretraining
  build-db             jsonl corpus -> sqlite document store
  build-index          corpus -> dense index artifacts (embeddings.npy, idx_id.json)
  encode-queries       questions -> query embedding .npy
  eval-retrieval       recall@k over the index
  retrieve             one-shot question -> top-k paragraphs
  cluster-corpus       k-means + per-cluster pretraining shards (group_paras)
  match-paras          weak-supervision gold-paragraph matching
  finetune-qa          joint retriever + reader QA training with online retrieval
  eval-qa              retrieve, read and decode: EM with the rank/span alpha sweep
  answer               inference-only QA: question(s) -> answer spans
  serve                HTTP QA server (/answer, /add, /remove) over a warm model
  convert-hf           HF / reference torch BERT or retriever checkpoint -> the port's .pt
  convert-trec / convert-msmarco   dataset converters

Flags and final JSON lines are the `proqa` CLI's, plus `--device` (default
cuda). Checkpoints are `.npz` files in the JAX layout, `.pt` state dicts, or
the `.pt` train checkpoints pretrain-retriever writes (models/convert.py).
`--int8-index` (eval-retrieval, retrieve and the QA commands) searches an
int8-quantized index (kernel K5); `--use-ivf` (the QA commands) an IVF view
of the index; `build-index --stream-chunk N` keeps host memory bounded by N
rows. `--shard-index` row-shards the index over every local CUDA device (the
--device itself on the CPU), and `--dp-encode` encodes data-parallel over
them. pretrain-retriever, finetune-qa and eval-qa run data-parallel when
launched by torchrun, one rank a card (`torchrun --nproc-per-node N -m
proqa_tpu_torch.cli.main ...`); rank 0 prints the final JSON line.
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
    from proqa_tpu_torch.models.retriever import Retriever, embed_dim_of

    params = load_params(args.init_checkpoint)
    model = Retriever(cfg, embed_dim_of(params))  # the checkpoint's width
    model.load_state_dict(params)
    return model.to(args.device).eval()


def _local_mesh(args) -> list:
    """Every local CUDA device for a CUDA --device, else the device alone."""
    import torch

    from proqa_tpu_torch.parallel import make_mesh

    if torch.device(args.device).type == "cuda":
        return make_mesh()
    return make_mesh(devices=[args.device])


def _dp_encode_mesh(args):
    """The mesh and batch size of --dp-encode (proqa_tpu/cli/main.py:99-115):
    encode batches split over every local device, the batch size rounded up
    to a multiple of their count."""
    if not getattr(args, "dp_encode", False):
        return None, args.predict_batch_size
    mesh = _local_mesh(args)
    n_dev = len(mesh)
    bsz = -(-args.predict_batch_size // n_dev) * n_dev
    if bsz != args.predict_batch_size:
        print(f"predict-batch-size {args.predict_batch_size} -> {bsz} "
              f"(multiple of {n_dev} devices)")
    return mesh, bsz


def _index_place(args, device, world: int = 1) -> dict:
    """DenseIndex.load's placement: --shard-index shards the rows over every
    local device, else the index sits on --device. A data-parallel run
    (world > 1) holds the whole index on each rank and refuses to shard it:
    that would need a search that is a collective across the processes."""
    if not getattr(args, "shard_index", False):
        return {"device": device}
    if world > 1:
        raise ValueError("--shard-index shards one process's index over its local devices; "
                         f"under data parallelism ({world} ranks) each rank holds the whole "
                         "index: drop --shard-index")
    return {"mesh": _local_mesh(args)}


def _index_dtype(args):
    """Index storage dtype: --int8-index wins over the f32/bf16 policy."""
    import torch

    if getattr(args, "int8_index", False):
        return "int8"
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
    p.add_argument("--shard-index", action="store_true",
                   help="shard the index rows over every local CUDA device (the --device "
                        "itself on the CPU); the candidates merge on the first")
    p.add_argument("--int8-index", action="store_true",
                   help="store the index block-int8-quantized: half the device memory of "
                        "bf16, search exact with respect to the quantized scores")


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
    if trainer.dp.main:
        print(json.dumps({"best_in_batch_acc": best}))


def cmd_build_index(args):
    from proqa_tpu_torch.index.build import build_index

    cfg = _bert_cfg(args, flash_default=True)
    mesh, batch_size = _dp_encode_mesh(args)
    index = build_index(
        _load_model(args, cfg), args.corpus, tokenizer=_tokenizer(args),
        max_length=args.max_seq_length, batch_size=batch_size,
        save_path=args.output_dir, dtype=cfg.dtype, stream_chunk=args.stream_chunk, mesh=mesh,
    )
    print(json.dumps({"rows": len(index), "dim": index.dim, "saved": args.output_dir}))


def cmd_encode_queries(args):
    from proqa_tpu_torch.data.datasets import EncodeDataset
    from proqa_tpu_torch.index.build import encode_corpus

    cfg = _bert_cfg(args, flash_default=True)
    ds = EncodeDataset(_tokenizer(args), args.queries,
                       max_query_length=args.max_query_length, is_query=True)
    mesh, batch_size = _dp_encode_mesh(args)
    emb = encode_corpus(_load_model(args, cfg), ds, batch_size=batch_size, is_query=True,
                        mesh=mesh)
    np.save(args.output, emb)
    print(json.dumps({"queries": int(emb.shape[0]), "saved": args.output}))


def cmd_eval_retrieval(args):
    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.recall import evaluate_retrieval

    index = DenseIndex.load(args.index, dtype=_index_dtype(args),
                            **_index_place(args, args.device))
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

    cfg = _bert_cfg(args, flash_default=True)
    model = _load_model(args, cfg)
    index = DenseIndex.load(args.index, dtype=_index_dtype(args),
                            **_index_place(args, args.device))
    db = DocDB(args.db) if args.db else None

    ids = _tokenizer(args).encode(args.question, max_length=args.max_query_length)
    ids = ids + [0] * (args.max_query_length - len(ids))
    ids_t = torch.tensor([ids], dtype=torch.int64, device=args.device)
    with torch.inference_mode():
        q = model.encode_query(ids_t, (ids_t != 0).to(torch.int32))
    vals, rows = index.search(q, args.topk)  # search casts to the scoring dtype
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


def cmd_cluster_corpus(args):
    from proqa_tpu_torch.index.cluster import cluster_corpus_embeddings, write_cluster_shards

    emb = np.load(args.embeddings)
    assignments = cluster_corpus_embeddings(
        emb, args.ncentroids, niter=args.niter,
        max_points_per_centroid=args.max_points_per_centroid,
        spherical=args.spherical, seed=args.seed, device=args.device,
    )
    n = write_cluster_shards(args.pairs, assignments, args.output_dir)
    # shard-size histogram: a handful of giant clusters would starve the
    # cluster-pure batch sampler of negatives
    sizes = np.bincount(assignments, minlength=args.ncentroids)
    nonzero = np.sort(sizes[sizes > 0])
    print(json.dumps({
        "shards": n, "ncentroids": args.ncentroids,
        "shard_sizes": {
            "min": int(nonzero[0]) if n else 0,
            "p50": int(np.median(nonzero)) if n else 0,
            "p99": int(np.percentile(nonzero, 99)) if n else 0,
            "max": int(nonzero[-1]) if n else 0,
            "empty": int((sizes == 0).sum()),
        },
    }))


def cmd_match_paras(args):
    from proqa_tpu_torch.qa.prepro import process_ground_paras

    coverage = process_ground_paras(
        args.retrieved, args.raw_data, args.output, args.db,
        k=args.topk, match="regex" if args.regex else "string",
        num_workers=args.num_workers,
    )
    print(json.dumps({"topk_gold_coverage": coverage}))


def _launched_world() -> int:
    """Ranks of the process group this process runs in or is launched into
    (torchrun's WORLD_SIZE), 1 without one."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _qa_setup(args, data_parallel: bool = True):
    """The QA model, index and sampler factory of finetune-qa, eval-qa,
    answer and serve (the JAX CLI's _qa_setup, proqa_tpu/cli/main.py:394-483).
    Weights: random from --seed, then --retriever-path into the retriever,
    --reader-path into the reader BERT, --init-checkpoint into the whole model
    (each a .npz in the JAX layout or a .pt; ';' averages).

    Launched by torchrun, each rank holds the whole index and its sampler
    reads the rank's share of the questions (rank r the r-th of every W);
    --questions-per-batch rounds to a multiple of ranks x microbatches and
    each rank's batch is its W-th. answer and serve pass
    data_parallel=False: they run in one process."""
    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.convert import load_params
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.models.retriever import embed_dim_of
    from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    cfg = _bert_cfg(args, flash_default=True)
    tok = _tokenizer(args)
    qcfg = QAConfig(
        shared_norm=args.shared_norm, separate=args.separate,
        add_select=args.add_select, drop_early=args.drop_early, qa_drop=args.qa_drop,
    )
    world = _launched_world()
    if world > 1 and not data_parallel:
        raise ValueError(f"{args.cmd} runs in one process, not in {world} ranks")
    _index_place(args, args.device, world)  # refuses --shard-index before any model is built
    # the question batch shards over the ranks and splits into grad-accum
    # microbatches: round it up to a multiple of both
    accum = max(1, args.accumulate_gradients)
    mult = world * accum
    qpb = -(-args.questions_per_batch // mult) * mult
    if qpb != args.questions_per_batch:
        print(f"questions-per-batch {args.questions_per_batch} -> {qpb} "
              f"(multiple of {world} devices x {accum} microbatches)")
    args.questions_per_batch = qpb
    tcfg = QATrainerConfig(
        learning_rate=args.learning_rate,
        accumulate_gradients=args.accumulate_gradients,
        prefetch_batches=args.prefetch,
        num_train_epochs=args.num_train_epochs,
        eval_period=args.eval_period,
        wait_step=args.wait_step,
        eval_k=args.eval_k,
        train_k=args.train_batch_size,
        questions_per_batch=args.questions_per_batch,
        fix_para_encoder=args.fix_para_encoder,
        freeze_retriever=args.fix_retriever,
        regex=args.regex,
        seed=args.seed,
        output_dir=args.output_dir,
        do_lower_case=not args.cased,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        adam_eps=args.adam_eps,
        max_answer_len=args.max_answer_len,
        profile_dir=args.profile_dir,
    )
    tcfg.questions_per_batch //= world  # this rank's share of each batch
    # the embedding width of the checkpoint that brings a retriever
    retriever = load_params(args.retriever_path) if args.retriever_path else None
    full = load_params(args.init_checkpoint) if args.init_checkpoint else None
    embed_dim = (embed_dim_of(full, "retriever.") if full is not None
                 else embed_dim_of(retriever or {}))
    # random weights from --seed
    trainer = QATrainer(cfg, qcfg, tcfg, device=args.device, embed_dim=embed_dim)
    if retriever is not None:
        trainer.model.retriever.load_state_dict(retriever)
    if args.reader_path:
        # a pretrained reader tower (e.g. a converted SpanBERT; pair with --cased)
        trainer.model.bert.load_state_dict(load_params(args.reader_path))
    if full is not None:
        trainer.model.load_state_dict(full)

    db = DocDB(args.db)
    index = DenseIndex.load(args.index, dtype=_index_dtype(args),
                            **_index_place(args, trainer.device, world))
    if args.use_ivf:
        # the reference's online-QA retrieval (IVF, nlist 100, nprobe 20)
        index = index.to_ivf(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe)
    scfg = OnlineSamplerConfig(
        max_query_length=args.max_query_length,
        max_length=args.max_seq_length,
        candidates=args.candidates,
        regex=args.regex,
        question_batch=tcfg.questions_per_batch,
        retrieval_batch=args.retrieval_batch,
        # IVF is approximate by construction: an exact search would bypass
        # the quantizer and make --use-ivf a no-op
        exact_search=not (args.approx_search or args.use_ivf),
    )

    def make_sampler(raw, matched=""):
        if world > 1:  # this rank's questions: the r-th of every W
            if isinstance(raw, str):
                with open(raw) as f:
                    raw = [json.loads(line) for line in f if line.strip()]
            raw = raw[trainer.dp.rank::world]
        return OnlineSampler(raw, tok, db, index, scfg, matched_para_path=matched)

    return trainer, make_sampler


def cmd_finetune_qa(args):
    trainer, make_sampler = _qa_setup(args)
    if args.resume:
        trainer.resume(args.resume)
    train_sampler = make_sampler(args.train_file, args.matched_para_path)
    eval_sampler = make_sampler(args.predict_file)
    best = trainer.train(train_sampler, eval_sampler)
    if trainer.dp.main:
        print(json.dumps({"best_em": best}))


def _serve_setup(args):
    """The `serve` command's server, built and not started (port 0 gives a
    free port): the QA stack of _qa_setup, a serving sampler whose groups
    are the MicroBatcher's drains (up to --max-batch questions, padded to
    power-of-two buckets), --warmup's answers at every bucket, and the
    IndexUpdater behind /add and /remove. The sampler and the updater hold
    the index, never its buffer: an add that grows it replaces
    `index.embeddings`."""
    import dataclasses

    from proqa_tpu_torch.qa.sampler import OnlineSampler
    from proqa_tpu_torch.serving import IndexUpdater, make_qa_server, warmup_buckets

    if args.shard_index:
        # /add and /remove mutate the index, which a sharded one refuses (the
        # JAX CLI's updater needs the unsharded index too, proqa_tpu/cli/main.py:581)
        raise ValueError("serve keeps live updates and takes the unsharded index: "
                         "drop --shard-index")
    trainer, make_sampler = _qa_setup(args, data_parallel=False)
    probe = make_sampler([])
    serve_cfg = dataclasses.replace(probe.cfg, question_batch=max(args.max_batch, 1),
                                    pad_buckets=True)

    def make_serve_sampler(raw):
        return OnlineSampler(raw, probe.tokenizer, probe.db, probe.index, serve_cfg)

    if args.warmup:
        for b in warmup_buckets(serve_cfg.question_batch):
            trainer.answer(make_serve_sampler([{"question": args.warmup}] * b),
                           alpha=args.alpha, topn=args.topn)
    updater = IndexUpdater(trainer, probe.tokenizer, probe.db, probe.index,
                           max_seq_length=args.max_seq_length)
    return make_qa_server(trainer, make_serve_sampler, host=args.host, port=args.port,
                          alpha=args.alpha, topn=args.topn, logger=trainer.logger,
                          updater=updater, max_batch=args.max_batch)


def cmd_serve(args):
    """HTTP QA serving (serving.py): the model and the device index stay warm
    across requests; prints {"serving": url}, then serves until interrupted."""
    server = _serve_setup(args)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}/answer"}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()


def cmd_eval_qa(args):
    trainer, make_sampler = _qa_setup(args)
    em = trainer.predict(
        make_sampler(args.predict_file),
        save_path=args.save_pred or None,
        save_all_prefix=args.save_all or None,
    )
    if trainer.dp.main:
        print(json.dumps({"em": em}))


def cmd_answer(args):
    """Open-domain QA inference: retrieve the top paragraphs, read, extract
    the best answer span per question; one JSON line per question."""
    if not (args.question or args.predict_file or args.stdin):
        raise SystemExit("answer: provide --question (repeatable), --predict-file, or --stdin")
    trainer, make_sampler = _qa_setup(args, data_parallel=False)
    if args.stdin:
        # warm loop: one JSON line out per question line in; the model and
        # the index stay on the device across questions
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                q = json.loads(line)["question"] if line.startswith("{") else line
                if not isinstance(q, str) or not q.strip():
                    raise ValueError("question must be a non-empty string")
            except (ValueError, KeyError) as e:
                # one bad producer line must not end the warm loop
                print(json.dumps({"error": f"{type(e).__name__}: {e}",
                                  "input": line[:200]}), flush=True)
                continue
            sampler = make_sampler([{"question": q}])
            for row in trainer.answer(sampler, alpha=args.alpha, topn=args.topn):
                print(json.dumps(row, ensure_ascii=False), flush=True)
        return
    data = [{"question": q} for q in args.question] if args.question else args.predict_file
    for row in trainer.answer(make_sampler(data), alpha=args.alpha, topn=args.topn):
        print(json.dumps(row, ensure_ascii=False))


def cmd_convert_hf(args):
    """A HF `BertModel` or reference `BertForRetriever` torch state dict ->
    the port's `.pt` state dict (of BertEncoder or Retriever), which
    --init-checkpoint, --retriever-path and --reader-path read."""
    import torch

    from proqa_tpu_torch.models.hf_convert import (
        bert_params_from_state_dict, load_torch_checkpoint,
        retriever_params_from_state_dict, strip_ddp_prefix,
    )

    if not args.output.endswith(".pt"):
        raise SystemExit(f"convert-hf writes a torch state dict: give --output a .pt path, "
                         f"not {args.output!r}")
    cfg = _bert_cfg(args)
    state = load_torch_checkpoint(args.torch_checkpoint, allow_pickle=args.allow_pickle)
    if args.kind == "retriever":
        params = retriever_params_from_state_dict(state, cfg)
    else:
        params = bert_params_from_state_dict(strip_ddp_prefix(state), cfg)
    torch.save(params, args.output)
    print(json.dumps({"saved": args.output, "kind": args.kind}))


def cmd_convert_trec(args):
    from proqa_tpu_torch.data.converters import trec_extract_labels, trec_prepare_corpus

    if args.collection:
        n = trec_prepare_corpus(args.collection, args.corpus_out)
        print(json.dumps({"corpus_rows": n}))
    if args.qrels:
        n = trec_extract_labels(args.qrels, args.queries, args.labels_out)
        print(json.dumps({"labeled_queries": n}))


def cmd_convert_msmarco(args):
    from proqa_tpu_torch.data.converters import msmarco_extract_qa

    n = msmarco_extract_qa(args.input, args.output)
    print(json.dumps({"qa_pairs": n}))


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
    sp.add_argument("--stream-chunk", type=int, default=0,
                    help="rows per streamed chunk: bounded host memory, the rows written "
                         "into <output-dir>/embeddings.npy as they are encoded (0: in memory)")
    sp.add_argument("--dp-encode", action="store_true",
                    help="split encode batches over every local CUDA device")
    sp.set_defaults(fn=cmd_build_index)

    sp = sub.add_parser("encode-queries")
    _add_common(sp)
    sp.add_argument("--queries", required=True, help='{"question"} jsonl')
    sp.add_argument("--init-checkpoint", required=True, help=".npz (JAX layout) or .pt")
    sp.add_argument("--output", required=True, help=".npy path")
    sp.add_argument("--predict-batch-size", type=int, default=512)
    sp.add_argument("--dp-encode", action="store_true",
                    help="split encode batches over every local CUDA device")
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

    sp = sub.add_parser("cluster-corpus")
    sp.add_argument("--embeddings", required=True, help="pair-paragraph embeds .npy")
    sp.add_argument("--pairs", required=True, help="pretraining pairs jsonl")
    sp.add_argument("--output-dir", required=True)
    sp.add_argument("--ncentroids", type=int, default=10000)
    sp.add_argument("--niter", type=int, default=250)
    sp.add_argument("--max-points-per-centroid", type=int, default=1000)
    sp.add_argument("--spherical", action="store_true")
    sp.add_argument("--seed", type=int, default=0)
    _add_device(sp)
    sp.set_defaults(fn=cmd_cluster_corpus)

    sp = sub.add_parser("match-paras")
    sp.add_argument("--retrieved", required=True)
    sp.add_argument("--raw-data", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--db", required=True)
    sp.add_argument("--topk", type=int, default=10000)
    sp.add_argument("--regex", action="store_true")
    sp.add_argument("--num-workers", type=int, default=0)
    sp.set_defaults(fn=cmd_match_paras)

    _add_qa_commands(sub)

    sp = sub.add_parser("convert-hf")
    _add_common(sp)
    sp.add_argument("--torch-checkpoint", required=True)
    sp.add_argument("--kind", choices=["bert", "retriever"], default="retriever")
    sp.add_argument("--output", required=True, help=".pt path")
    sp.add_argument("--allow-pickle", action="store_true",
                    help="permit full unpickling for legacy checkpoints that fail the safe "
                         "weights-only load (trusted files only)")
    sp.set_defaults(fn=cmd_convert_hf)

    sp = sub.add_parser("convert-trec")
    sp.add_argument("--collection", default="")
    sp.add_argument("--corpus-out", default="trec_corpus.jsonl")
    sp.add_argument("--qrels", default="")
    sp.add_argument("--queries", default="")
    sp.add_argument("--labels-out", default="trec_labels.jsonl")
    sp.set_defaults(fn=cmd_convert_trec)

    sp = sub.add_parser("convert-msmarco")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_convert_msmarco)

    sp = sub.add_parser("build-db")
    sp.add_argument("--corpus", required=True, help='{"text", ["id"]} jsonl')
    sp.add_argument("--db", required=True, help="output sqlite path")
    sp.set_defaults(fn=cmd_build_db)
    return p


def _add_qa_commands(sub) -> None:
    """finetune-qa, eval-qa, answer and serve with the JAX parser's flags
    (proqa_tpu/cli/main.py:747-850)."""
    helps = {
        "finetune-qa": "joint retriever + reader QA training with online retrieval",
        "answer": "question(s) -> extracted answer spans (inference only)",
        "serve": "HTTP QA serving with live index updates (/answer, /add, /remove)",
    }
    for name, fn in (("finetune-qa", cmd_finetune_qa), ("eval-qa", cmd_eval_qa),
                     ("answer", cmd_answer), ("serve", cmd_serve)):
        sp = sub.add_parser(name, help=helps.get(name))
        _add_common(sp)
        sp.add_argument("--train-file", default="")
        sp.add_argument("--predict-file", required=name not in ("answer", "serve"), default="",
                        help="jsonl of {question[, answer]}" if name == "answer" else None)
        sp.add_argument("--db", required=True)
        sp.add_argument("--index", required=True)
        sp.add_argument("--matched-para-path", default="")
        sp.add_argument("--output-dir", default="logs/qa")
        sp.add_argument("--init-checkpoint", default="",
                        help="the whole QA model: .npz (JAX layout) or .pt")
        sp.add_argument("--retriever-path", default="", help="retriever weights: .npz or .pt")
        sp.add_argument("--reader-path", default="",
                        help="pretrained reader BERT (e.g. converted SpanBERT; use with --cased)")
        sp.add_argument("--train-batch-size", type=int, default=5, help="k paras/question")
        sp.add_argument("--questions-per-batch", type=int, default=1)
        sp.add_argument("--candidates", type=int, default=5000)
        sp.add_argument("--retrieval-batch", type=int, default=0,
                        help="questions retrieved per device call during training "
                             "(0 = questions-per-batch)")
        sp.add_argument("--eval-k", type=int, default=5)
        sp.add_argument("--learning-rate", type=float, default=1e-5)
        sp.add_argument("--weight-decay", type=float, default=0.0)
        sp.add_argument("--max-grad-norm", type=float, default=5.0)
        sp.add_argument("--adam-eps", type=float, default=1e-8)
        sp.add_argument("--max-answer-len", type=int, default=10,
                        help="max answer span in wordpieces at decode; the reference "
                             "hardcodes 10 despite its flag's default 20 "
                             "(train_retrieve_qa.py:301)")
        sp.add_argument("--accumulate-gradients", type=int, default=1,
                        help="grad-accum microbatches per optimizer step")
        sp.add_argument("--prefetch", type=int, default=0,
                        help="sampler batches built ahead of the device by a thread "
                             "(0: off, the default; the JAX CLI's is 2)")
        sp.add_argument("--num-train-epochs", type=int, default=20)
        sp.add_argument("--eval-period", type=int, default=-1)
        sp.add_argument("--wait-step", type=int, default=100)
        sp.add_argument("--shared-norm", action="store_true")
        sp.add_argument("--separate", action="store_true")
        sp.add_argument("--add-select", action="store_true")
        sp.add_argument("--drop-early", action="store_true")
        sp.add_argument("--qa-drop", type=float, default=0.0)
        sp.add_argument("--fix-para-encoder", action="store_true")
        sp.add_argument("--fix-retriever", action="store_true",
                        help="freeze the whole retriever submodule")
        sp.add_argument("--regex", action="store_true")
        sp.add_argument("--approx-search", action="store_true")
        sp.add_argument("--use-ivf", action="store_true",
                        help="search an IVF view of the index (approximate; "
                             "reference online-QA setting)")
        sp.add_argument("--ivf-nlist", type=int, default=100)
        sp.add_argument("--ivf-nprobe", type=int, default=20)
        _shard_index_arg(sp)
        sp.add_argument("--save-pred", default="", help="write best-alpha predictions jsonl")
        sp.add_argument("--save-all", default="", metavar="PREFIX",
                        help="dump all candidate predictions + ground truths + "
                             "per-alpha top-1 files under PREFIX (reference --save-all)")
        if name in ("answer", "serve"):
            sp.add_argument("--alpha", type=float, default=0.8,
                            help="span-vs-rank score mix for candidate ranking")
            sp.add_argument("--topn", type=int, default=3,
                            help="candidate answers to include per question")
        if name == "answer":
            sp.add_argument("--question", action="append", default=[],
                            help="question text (repeatable; alternative to --predict-file)")
            sp.add_argument("--stdin", action="store_true",
                            help="serve a question per stdin line (text or "
                                 "{\"question\": ...} json), model kept warm")
        if name == "finetune-qa":
            sp.add_argument("--resume", default="", help="a checkpoint_last.pt of an earlier run")
        if name == "serve":
            sp.add_argument("--host", default="127.0.0.1")
            sp.add_argument("--port", type=int, default=8080)
            sp.add_argument("--warmup", default="")
            sp.add_argument("--max-batch", type=int, default=16)
        sp.set_defaults(fn=fn)


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
