"""Port parity for QA finetuning's pieces: the loss zoo, the frozen-parameter
masks, AdamW with frozen groups, and whole train steps against the JAX
package's `QATrainer._train_step`, plus the repairs of the port's query
encoder and trainer config, and the int8 rank-head finding."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.models import reader as jax_reader  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.parallel.mesh import make_mesh  # noqa: E402
from proqa_tpu.train import optim as jax_optim  # noqa: E402
from proqa_tpu.train import qa_trainer as jax_qa_trainer  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models import reader  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.reader import QAConfig, QAModel, qa_frozen_mask, qa_loss  # noqa: E402
from proqa_tpu_torch.train import optim  # noqa: E402
from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig  # noqa: E402

# f32 on both sides, other summation orders (XLA's CPU kernels against
# PyTorch's): ~1e-7 relative on the loss terms
LOSS_RTOL = 1e-5
# whole train steps: the tolerance tests/test_torch_train.py holds the
# retriever's steps to (f32, three Adam steps keep ~1e-7 noise far below it)
TOL = 1e-5
FLAGS = ("shared_norm", "separate", "add_select", "drop_early")


def _loss_case(rng, B=4, k=3, L=12, S=3, M=10):
    """Logits as the forward makes them (NEG outside a paragraph) and targets
    with every guard: question 1 has no gold at all, question 2 spans but no
    gold paragraph among the candidates, question 3 a gold paragraph but no
    span."""
    para = np.zeros((B, k, L), bool)
    para[:, :, 3:-1] = True
    start = np.where(para, rng.standard_normal((B, k, L)), reader.NEG).astype(np.float32)
    end = np.where(para, rng.standard_normal((B, k, L)), reader.NEG).astype(np.float32)
    sp = rng.integers(3, L - 1, size=(B, k, S))
    sp[rng.random((B, k, S)) < 0.4] = -1
    sp[1] = sp[3] = -1
    ep = np.where(sp >= 0, np.minimum(sp + rng.integers(0, 3, size=sp.shape), L - 2), -1)
    labels = (rng.random((B, M)) < 0.3).astype(np.int32)
    labels[0, 0] = 1
    labels[1] = labels[2] = 0
    labels[3, 1] = 1
    out = {"start_logits": start, "end_logits": end,
           "rank_logits": rng.standard_normal((B, M)).astype(np.float32),
           "select_logits": rng.standard_normal((B, k)).astype(np.float32)}
    batch = {"start_positions": sp.astype(np.int32), "end_positions": ep.astype(np.int32),
             "top5000_labels": labels,
             "para_targets": (sp >= 0).any(-1).astype(np.int32)}
    return out, batch


def _jax_loss_and_grads(out, batch, jcfg):
    def f(o):
        comp = jax_reader.qa_loss(o, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        return comp["loss"], comp

    (_, comp), grads = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    return {k: float(v) for k, v in comp.items()}, {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(out, batch, qcfg):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    comp = qa_loss(leaves, {k: torch.from_numpy(v) for k, v in batch.items()}, qcfg)
    comp["loss"].backward()
    return ({k: float(v) for k, v in comp.items()},
            {k: (v.grad.numpy() if v.grad is not None else np.zeros_like(out[k]))
             for k, v in leaves.items()})


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=4)),
                         ids=lambda f: "-".join(n for n, on in zip(FLAGS, f) if on) or "joint")
def test_qa_loss_matches_jax(flags):
    """Every flag combination: each component and the gradients of every
    logit, with the guards, and with a question_mask that drops a padded
    question (a copy of question 0, as batch_pad makes it)."""
    kw = dict(zip(FLAGS, flags))
    rng = np.random.default_rng(sum(b << i for i, b in enumerate(flags)))
    out, batch = _loss_case(rng)
    for qmask in (None, np.array([1, 1, 1, 0], np.int32)):
        if qmask is not None:
            out = {k: np.concatenate([v[:3], v[:1]]) for k, v in out.items()}
            batch = {k: np.concatenate([v[:3], v[:1]]) for k, v in batch.items()}
            batch["question_mask"] = qmask
        want, want_g = _jax_loss_and_grads(out, batch, jax_reader.QAConfig(**kw))
        got, got_g = _torch_loss_and_grads(out, batch, QAConfig(**kw))
        assert set(got) == set(want)
        # the keys a data-parallel step that has no batch left reduces
        assert tuple(got) == reader.qa_loss_keys(QAConfig(**kw))
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL, abs=1e-6), key
        for key in want_g:
            assert np.isfinite(got_g[key]).all(), key
            np.testing.assert_allclose(got_g[key], want_g[key], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=key)
        if qmask is not None:  # the padded row carries no gradient
            assert all(not got_g[key][3].any() for key in got_g)


@pytest.mark.parametrize("separate", [False, True])
def test_qa_loss_no_gold_is_zero_with_finite_gradients(separate):
    """No gold paragraph and no span anywhere: loss 0 and zero, finite
    gradients (torch.logsumexp's NaN gradient over a row of only -inf must
    land on the guards' constants)."""
    rng = np.random.default_rng(3)
    out, batch = _loss_case(rng)
    batch["start_positions"][:] = batch["end_positions"][:] = -1
    batch["top5000_labels"][:] = batch["para_targets"][:] = 0
    comp, grads = _torch_loss_and_grads(out, batch, QAConfig(separate=separate))
    assert comp["loss"] == 0.0
    assert all(np.isfinite(g).all() and not g.any() for g in grads.values())


@pytest.mark.parametrize("fix_c,fix_r", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_qa_frozen_mask_matches_jax(fix_c, fix_r):
    jcfg = JaxBertConfig.tiny()
    params = jax_reader.init_qa_params(jax.random.PRNGKey(0), jcfg,
                                       jax_reader.QAConfig(add_select=True))
    jmask = jax_reader.qa_frozen_mask(params, freeze_c_encoder=fix_c, freeze_retriever=fix_r)
    want = {}
    for path, frozen in jax.tree_util.tree_leaves_with_path(jmask):
        keys = [p.key for p in path]
        if "layers" in keys:  # stacked in JAX: one flag for every layer
            at = keys.index("layers") + 1
            for i in range(jcfg.num_layers):
                want[".".join(keys[:at] + [str(i)] + keys[at:])] = bool(frozen)
        else:
            want[".".join(keys)] = bool(frozen)
    names = dict(QAModel(BertConfig.tiny(), QAConfig(add_select=True)).named_parameters())
    got = qa_frozen_mask(names, freeze_c_encoder=fix_c, freeze_retriever=fix_r)
    assert got == want
    assert any(got.values()) == (fix_c or fix_r)


def _tree_grads(params, rng, frozen_tree):
    """Random gradients; frozen leaves get a large one (100), which a global
    norm over every leaf would see."""
    return jax.tree.map(
        lambda p, f: (np.full(p.shape, 100.0, np.float32) if f
                      else rng.standard_normal(p.shape).astype(np.float32)),
        params, frozen_tree)


@pytest.mark.parametrize("fix_c,fix_r", [(False, False), (True, False), (False, True)],
                         ids=["neither", "fix_para_encoder", "freeze_retriever"])
def test_frozen_adamw_matches_optax(fix_c, fix_r):
    """Three AdamW steps with optax's multi_transform / set_to_zero against
    the port's frozen groups: frozen parameters do not move and have no
    moments, and the global-norm clip (binding here) counts only the
    trainable gradients."""
    jcfg = JaxBertConfig.tiny()
    params = jax.tree.map(np.asarray, jax_reader.init_qa_params(
        jax.random.PRNGKey(1), jcfg, jax_reader.QAConfig()))
    jmask = jax_reader.qa_frozen_mask(params, freeze_c_encoder=fix_c, freeze_retriever=fix_r)
    kw = dict(learning_rate=1e-2, weight_decay=0.01, max_grad_norm=1.0)
    tx = jax_optim.make_optimizer(frozen_mask=jmask, **kw)
    jstate = jax_optim.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    tparams = convert.params_from_jax(params)
    frozen = qa_frozen_mask(tparams, freeze_c_encoder=fix_c, freeze_retriever=fix_r)
    tstate = optim.init_train_state(tparams, frozen)
    assert set(tstate.opt_state["mu"]) == {k for k, f in frozen.items() if not f}
    rng = np.random.default_rng(2)
    grads = [_tree_grads(params, rng, jmask) for _ in range(3)]
    for g in grads:
        jstate = jax_optim.apply_gradients(jstate, jax.tree.map(jnp.asarray, g), tx)
        tstate = optim.apply_gradients(tstate, convert.params_from_jax(g), optim.AdamW(**kw))
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    start = convert.params_from_jax(params)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if frozen[name]:
            assert torch.equal(p, start[name]), name
    if fix_r:
        # the same steps with the frozen gradients zeroed give the same
        # parameters: the frozen leaves' 100s never entered the norm
        again = optim.init_train_state(convert.params_from_jax(params), frozen)
        for g in grads:
            g0 = jax.tree.map(lambda x, f: x * 0 if f else x, g, jmask)
            again = optim.apply_gradients(again, convert.params_from_jax(g0), optim.AdamW(**kw))
        assert all(torch.equal(again.params[k], p) for k, p in tstate.params.items())


# ---------------------------------------------------------------------------
# whole train steps against QATrainer._train_step
# ---------------------------------------------------------------------------

B, K, T, TQ, M, N_ROWS = 4, 2, 128, 8, 12, 40
LOSSES = {"joint": {}, "separate_select": {"separate": True, "add_select": True},
          "shared_norm": {"shared_norm": True}}


def _train_batch(rng, vocab=128):
    """A host batch as the sampler and batch_pad make it: paragraphs after a
    6-token question, span targets inside them, rank candidates as index rows
    (-1 for an under-filled slot), the last question a padded copy of the
    first (question_mask 0)."""
    ids = rng.integers(5, vocab, size=(B, K, T)).astype(np.int32)
    ids[..., 0], ids[..., 6] = 2, 3
    lengths = rng.integers(40, T + 1, size=(B, K))
    live = np.arange(T)[None, None] < lengths[..., None]
    ids = np.where(live, ids, 0)
    seg = (np.arange(T)[None, None] >= 7) & live
    para = seg & (np.arange(T)[None, None] < lengths[..., None] - 1)
    sp = rng.integers(7, 38, size=(B, K, 3))
    sp[rng.random((B, K, 3)) < 0.5] = -1
    sp[1, :, :] = -1
    ep = np.where(sp >= 0, sp + rng.integers(0, 3, size=sp.shape), -1)
    rows = rng.integers(0, N_ROWS, size=(B, M)).astype(np.int32)
    rows[:, -1] = -1
    labels = (rng.random((B, M)) < 0.2).astype(np.int32)
    labels[:, -1] = 0
    q = rng.integers(5, vocab, size=(B, TQ)).astype(np.int32)
    q[:, 0], q[:, 5:] = 2, 0
    net = {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32),
           "segment_ids": seg.astype(np.int32), "paragraph_mask": para.astype(np.int32),
           "input_ids_q": q, "input_mask_q": (q != 0).astype(np.int32), "para_rows": rows,
           "start_positions": sp.astype(np.int32), "end_positions": ep.astype(np.int32),
           "para_targets": (sp >= 0).any(-1).astype(np.int32), "top5000_labels": labels}
    net = {k: np.concatenate([v[:B - 1], v[:1]]) for k, v in net.items()}
    net["question_mask"] = (np.arange(B) < B - 1).astype(np.int32)
    return net


_JAX_RUNS = {}


def _jax_run(loss, accum, jcfg, qkw, params, emb, batches, tkw):
    """Losses and parameters of the JAX trainer's steps (cached per case)."""
    key = (loss, accum)
    if key not in _JAX_RUNS:
        trainer = jax_qa_trainer.QATrainer(
            jcfg, jax_reader.QAConfig(**qkw),
            jax_qa_trainer.QATrainerConfig(accumulate_gradients=accum, fast_prng=False, **tkw),
            mesh=make_mesh(1), params=jax.tree.map(jnp.asarray, params))
        trainer.set_corpus(JaxDenseIndex.from_embeddings(emb, dtype=jnp.float32, pad_multiple=8))
        comps = []
        for i, net in enumerate(batches):
            trainer.state, comp = trainer._train_step(trainer.state, dict(net),
                                                      jax.random.PRNGKey(i))
            comps.append({k: float(v) for k, v in comp.items()})
        _JAX_RUNS[key] = comps, jax.tree.map(np.asarray, trainer.state.params)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_qa_train_step_matches_jax(tmp_path, loss, accum):
    """Two train steps at dropout 0 (f32, T = 128 so the reader's attention
    runs the fused path: K2/K3's plain versions here), candidates gathered
    from the registered index through para_rows, a padded question masked
    out: the loss components and every parameter equal the JAX trainer's."""
    kw = dict(max_position_embeddings=T, flash_attention=True, hidden_dropout=0.0,
              attention_dropout=0.0, initializer_range=0.1)
    jcfg = JaxBertConfig.tiny(dtype=jnp.float32, **kw)
    qkw = LOSSES[loss]
    params = jax.tree.map(np.asarray, jax_reader.init_qa_params(
        jax.random.PRNGKey(4), jcfg, jax_reader.QAConfig(**qkw)))
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((N_ROWS, 128)).astype(np.float32)
    batches = [_train_batch(rng) for _ in range(2)]
    # Adam's eps at 1e-6 as in tests/test_torch_train.py: gradients that are
    # zero in exact arithmetic carry rounding noise that differs by backend
    tkw = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0, adam_eps=1e-6,
               questions_per_batch=B, output_dir=str(tmp_path / "jax"))
    want_comps, want_params = _jax_run(loss, accum, jcfg, qkw, params, emb, batches, tkw)

    trainer = QATrainer(BertConfig.tiny(dtype=torch.float32, remat=True, **kw), QAConfig(**qkw),
                        QATrainerConfig(accumulate_gradients=accum,
                                        **dict(tkw, output_dir=str(tmp_path / "torch"))),
                        params=convert.params_from_jax(params), device="cpu")
    trainer.set_corpus(DenseIndex.from_embeddings(emb, device="cpu", dtype=torch.float32))
    for net, want in zip(batches, want_comps):
        got = trainer._train_step(dict(net))
        assert set(got) == set(want)
        for key in want:
            assert float(got[key]) == pytest.approx(want[key], rel=TOL, abs=TOL), key
    assert trainer.state.step == 2 and not trainer.model.training
    got_params = convert.params_to_jax({k: p.detach() for k, p in trainer.state.params.items()})
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_params),
                                 jax.tree_util.tree_leaves_with_path(want_params)):
        keys = tuple(p.key for p in path)
        # zero gradient in exact arithmetic (a constant added to every score
        # of a softmax row: the key bias, and the span and select heads'
        # biases): rounding noise drives these on both sides, and Adam moves
        # an element at most ~lr a step whatever the gradient
        noise_only = (keys[-3:] == ("layers", "k", "bias")
                      or keys in (("qa_outputs", "bias"), ("select_outputs", "bias")))
        atol = len(batches) * tkw["learning_rate"] if noise_only else TOL
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=str(path))


def test_train_step_without_corpus_raises(tmp_path):
    trainer = QATrainer(BertConfig.tiny(dtype=torch.float32, max_position_embeddings=T),
                        QAConfig(), QATrainerConfig(questions_per_batch=B,
                                                    output_dir=str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="set_corpus"):
        trainer._train_step(_train_batch(np.random.default_rng(0)))


def test_train_step_frozen_groups_and_qa_drop(tmp_path):
    """With dropout, qa_drop and --fix-para-encoder: the context tower and
    its projection stay bit-equal and hold no moments, everything the loss
    reaches moves, the model returns to eval mode, and the step's dropout
    depends on the trainer's generator (two seeds, two results)."""
    cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=T, flash_attention=True)
    results = []
    for seed in (1, 1, 2):
        trainer = QATrainer(cfg, QAConfig(qa_drop=0.2), QATrainerConfig(
            questions_per_batch=B, learning_rate=1e-3, seed=seed,
            output_dir=str(tmp_path / str(seed))),
            params=QAModel(cfg, QAConfig()).reset_parameters(0).state_dict(), device="cpu")
        trainer.set_corpus(DenseIndex.from_embeddings(
            np.random.default_rng(0).standard_normal((N_ROWS, 128)).astype(np.float32),
            device="cpu", dtype=torch.float32))
        before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        comp = trainer._train_step(_train_batch(np.random.default_rng(6)))
        assert np.isfinite(float(comp["loss"])) and not trainer.model.training
        after = dict(trainer.model.named_parameters())
        for name, p in after.items():
            frozen = name.startswith(("retriever.bert_c.", "retriever.proj_c."))
            assert frozen == (name not in trainer.state.opt_state["mu"]), name
            if frozen:
                assert torch.equal(p, before[name]), name
        assert not torch.equal(after["bert.layers.0.q.kernel"], before["bert.layers.0.q.kernel"])
        assert not torch.equal(after["retriever.bert_q.layers.0.q.kernel"],
                               before["retriever.bert_q.layers.0.q.kernel"])
        results.append(float(comp["loss"]))
    assert results[0] == results[1] != results[2]


def test_query_encoder_between_train_steps(tmp_path):
    """The sampler's query encoder between two train steps (dropout on): no
    error, no dropout (equal to the query tower in eval mode, also while the
    model sits in training mode), and it sees the weights each step wrote, as
    tests/test_qa_pipeline.py:test_query_encoder_tracks_live_params holds
    JAX's encoder to."""
    cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=T)
    trainer = QATrainer(cfg, QAConfig(), QATrainerConfig(
        questions_per_batch=B, learning_rate=1e-2, fix_para_encoder=False,
        output_dir=str(tmp_path)), device="cpu")
    trainer.set_corpus(DenseIndex.from_embeddings(
        np.random.default_rng(0).standard_normal((N_ROWS, 128)).astype(np.float32),
        device="cpu", dtype=torch.float32))
    enc = trainer.query_encoder()
    ids = np.array([[2, 5, 6, 3, 0, 0], [2, 9, 3, 0, 0, 0]], np.int32)
    mask = (ids != 0).astype(np.int32)

    def eval_tower():
        fresh = QAModel(cfg, QAConfig())
        fresh.load_state_dict(trainer.model.state_dict())
        with torch.no_grad():
            return fresh.eval().retriever.encode_query(torch.from_numpy(ids).long(),
                                                       torch.from_numpy(mask))

    rng = np.random.default_rng(7)
    seen = []
    for _ in range(2):
        trainer._train_step(_train_batch(rng))
        e = enc(ids, mask)
        torch.testing.assert_close(e, eval_tower(), rtol=0, atol=0)
        trainer.model.train()
        torch.testing.assert_close(enc(ids, mask), e, rtol=0, atol=0)
        trainer.model.eval()
        seen.append(e)
    assert not torch.allclose(seen[0], seen[1])


def test_qa_trainer_config_matches_jax_fields():
    jax_fields = {f.name for f in dataclasses.fields(jax_qa_trainer.QATrainerConfig)}
    ours = {f.name for f in dataclasses.fields(QATrainerConfig)}
    assert ours == jax_fields - {"fast_prng"}  # the TPU's hardware-RNG switch


def test_qa_trainer_rejects_indivisible_batch(tmp_path):
    with pytest.raises(ValueError, match="microbatches"):
        QATrainer(BertConfig.tiny(), QAConfig(), QATrainerConfig(
            questions_per_batch=5, accumulate_gradients=2, output_dir=str(tmp_path)),
            device="cpu")


def test_int8_corpus_rank_head(tmp_path):
    """A fault of the reference, confirmed: with an int8 index the JAX
    trainer registers the raw codes as corpus_emb (qa_trainer.py:227-234),
    so its training rank head multiplies the queries by unscaled codes. The
    port gathers the dequantized rows (DenseIndex.gather), the rows the
    search scored (ROADMAP Queue 3)."""
    rng = np.random.default_rng(8)
    emb = (rng.standard_normal((1024, 128)) * 0.05).astype(np.float32)
    jindex = JaxDenseIndex.from_embeddings(emb, dtype="int8")
    jtrainer = jax_qa_trainer.QATrainer(
        JaxBertConfig.tiny(dtype=jnp.float32), jax_reader.QAConfig(),
        jax_qa_trainer.QATrainerConfig(fast_prng=False, output_dir=str(tmp_path)),
        mesh=make_mesh(1), params=jax_reader.init_qa_params(
            jax.random.PRNGKey(0), JaxBertConfig.tiny(dtype=jnp.float32), jax_reader.QAConfig()))
    jtrainer.set_corpus(jindex)
    assert jtrainer._corpus_emb.dtype == jnp.int8
    rows = rng.integers(0, 1024, size=(2, 6)).astype(np.int32)
    q = rng.standard_normal((2, 128)).astype(np.float32)
    gathered = np.asarray(jnp.take(jtrainer._corpus_emb, rows, axis=0, mode="clip"),
                          np.float32)
    dequantized = np.asarray(jindex.take(rows.reshape(-1))).reshape(2, 6, 128)
    # what qa_forward's einsum multiplies: codes of magnitude up to 127
    assert np.abs(gathered).max() > 50 and np.abs(dequantized).max() < 1
    index = DenseIndex.from_embeddings(emb, device="cpu", dtype="int8")
    got = index.gather(torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, dequantized, rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.einsum("bd,bmd->bm", q, gathered),
                           np.einsum("bd,bmd->bm", q, got))
    # the port's train step hands the model those dequantized rows
    trainer = QATrainer(BertConfig.tiny(dtype=torch.float32, max_position_embeddings=T),
                        QAConfig(), QATrainerConfig(questions_per_batch=B,
                                                    output_dir=str(tmp_path / "torch")),
                        device="cpu")
    trainer.set_corpus(index)
    seen = []
    forward = trainer.model.forward
    trainer.model.forward = lambda batch, **kw: (seen.append(batch["para_embed"]),
                                                 forward(batch, **kw))[1]
    net = _train_batch(np.random.default_rng(9))
    net["para_rows"] = np.minimum(net["para_rows"] * 25, 1023).astype(np.int32)
    assert np.isfinite(float(trainer._train_step(net)["loss"]))
    np.testing.assert_allclose(
        seen[0].numpy(), index.take(net["para_rows"].reshape(-1)).reshape(B, M, 128), rtol=0, atol=0)
