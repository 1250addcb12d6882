"""Port parity for retriever pretraining: the in-batch loss, AdamW's
trajectory, whole train steps against the JAX package's `make_train_step`,
the trainer's early-stop / checkpoint / resume semantics (mirroring
tests/test_train.py), and a tiny model that learns from scratch."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.models import bert as jax_bert  # noqa: E402
from proqa_tpu.models.retriever import init_retriever_params, retriever_forward  # noqa: E402
from proqa_tpu.train import optim as jax_optim  # noqa: E402
from proqa_tpu.train import retriever_trainer as jax_trainer  # noqa: E402
from proqa_tpu_torch.models import convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402
from proqa_tpu_torch.testing import ZERO_GRAD_ULPS, zero_grad_ratio, zero_grad_unit  # noqa: E402,E501
from proqa_tpu_torch.train import optim  # noqa: E402
from proqa_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint  # noqa: E402
from proqa_tpu_torch.train.retriever_trainer import (  # noqa: E402
    RetrieverTrainer, RetrieverTrainerConfig, in_batch_loss, train_step,
)

# f32 on both sides; the sums run in other orders (XLA's CPU dot against
# PyTorch's), ~1e-7 relative, and three Adam steps keep that far below 1e-5
TOL = 1e-5


def _toy_batches(n_batches, bsz, vocab=128, seed=0, c_len=4):
    """Paired (q, c) token sequences where matching pairs share a token (the
    batches of tests/test_train.py; c_len > 4 pads the contexts)."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        pair_tok = rng.integers(5, vocab, size=bsz)
        q = np.stack([[2, t, 3, 0] for t in pair_tok]).astype(np.int32)
        c = np.zeros((bsz, c_len), np.int32)
        c[:, :4] = np.stack([[2, t, rng.integers(5, vocab), 3] for t in pair_tok])
        c[: bsz // 2, 4: 4 + c_len // 3] = rng.integers(5, vocab, size=(bsz // 2, c_len // 3))
        batches.append({
            "input_ids_q": q, "input_mask_q": (q != 0).astype(np.int32),
            "input_ids_c": c, "input_mask_c": (c != 0).astype(np.int32),
        })
    return batches


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k.startswith("input_ids") else torch.from_numpy(v)
            for k, v in batch.items()}


def test_in_batch_loss_matches_jax():
    rng = np.random.default_rng(0)
    out = {"q": rng.standard_normal((6, 16)).astype(np.float32),
           "c": rng.standard_normal((6, 16)).astype(np.float32)}
    out["c"][2] = out["q"][2] * 3
    jl, ja = jax_trainer.in_batch_loss({k: jnp.asarray(v) for k, v in out.items()})
    tl, ta = in_batch_loss({k: torch.from_numpy(v) for k, v in out.items()})
    assert abs(float(tl) - float(jl)) < 1e-6
    assert float(ta) == float(ja)
    d = torch.eye(4, 8)
    loss, acc = in_batch_loss({"q": d * 10, "c": d * 10})
    assert float(acc) == 1.0 and float(loss) < 0.01


def test_decay_mask_matches_jax():
    params = init_retriever_params(jax.random.PRNGKey(0), jax_bert.BertConfig.tiny())
    jmask = jax_optim._no_decay_mask(params)
    names = set(Retriever(BertConfig.tiny()).state_dict())
    checked = 0
    for path, decays in jax.tree_util.tree_leaves_with_path(jmask):
        keys = [p.key for p in path]
        if "layers" in keys:  # stacked in JAX: layer 0 stands for all
            keys.insert(keys.index("layers") + 1, "0")
        name = ".".join(keys)
        assert name in names and optim.decays(name) == decays, name
        checked += 1
    assert checked == 50  # 23 leaves per tower, 2 per projection
    assert not optim.decays("bert_q.layers.0.attn_ln.scale")
    assert optim.decays("bert_q.embeddings.word")


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-2, max_grad_norm=0.5),                          # clip binds
    dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6),
    dict(learning_rate=3e-3, weight_decay=0.01, max_grad_norm=100.0, adam_eps=1e-6),
])
def test_optimizer_trajectory_matches_optax(kw):
    rng = np.random.default_rng(1)
    params = {"w": {"kernel": rng.standard_normal((5, 4)).astype(np.float32),
                    "bias": rng.standard_normal(4).astype(np.float32)},
              "ln": {"scale": rng.standard_normal(4).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 2, params)
             for _ in range(5)]
    tx = jax_optim.make_optimizer(**kw)
    jstate = jax_optim.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    names = {"w.kernel": ("w", "kernel"), "w.bias": ("w", "bias"), "ln.scale": ("ln", "scale")}
    tparams = {n: torch.tensor(params[a][b]) for n, (a, b) in names.items()}
    tstate = optim.init_train_state(tparams)
    ttx = optim.AdamW(**kw)
    for g in grads:
        jstate = jax_optim.apply_gradients(jstate, jax.tree.map(jnp.asarray, g), tx)
        tstate = optim.apply_gradients(
            tstate, {n: torch.tensor(g[a][b]) for n, (a, b) in names.items()}, ttx)
        for n, (a, b) in names.items():
            np.testing.assert_allclose(tstate.params[n].numpy(),
                                       np.asarray(jstate.params[a][b]), atol=1e-6, rtol=0)
    assert tstate.step == int(jstate.step) == 5


_JAX_STEPS = {}


def _jax_trajectory(flash, accum, batches, jcfg, jparams, tx_kw):
    """Loss and parameters of the JAX train step over the batches (cached:
    remat does not change the numbers, so every remat case shares it)."""
    key = (flash, accum)
    if key not in _JAX_STEPS:
        tx = jax_optim.make_optimizer(**tx_kw)
        state = jax_optim.init_train_state(jparams, tx)
        step = jax.jit(jax_trainer.make_train_step(jcfg, tx, accum))
        losses = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
        _JAX_STEPS[key] = (losses, jax.tree.map(np.asarray, state.params))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("scope", ["layer", "mlp"])
@pytest.mark.parametrize("flash", [True, False])
def test_train_step_matches_jax(flash, scope, accum):
    # init 0.1 as in the learning test: at 0.02 a tiny random model's loss is
    # nearly flat, gradients sit near Adam's eps (1e-8) and their last-bit
    # noise decides the update's size
    kw = dict(max_position_embeddings=128, flash_attention=flash, hidden_dropout=0.0,
              attention_dropout=0.0, initializer_range=0.1)
    jcfg = jax_bert.BertConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = BertConfig.tiny(dtype=torch.float32, remat=True, remat_scope=scope, **kw)
    jparams = jax.tree.map(np.asarray, init_retriever_params(jax.random.PRNGKey(2), jcfg))
    batches = _toy_batches(3, 8, c_len=128, seed=3)
    # Adam's eps at 1e-6: some gradients are zero in exact arithmetic (the key
    # bias: softmax ignores a constant added to a row), and at eps 1e-8 their
    # ~1e-10 rounding noise, which differs between XLA and PyTorch, becomes an
    # update of up to 0.1 lr
    tx_kw = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0, adam_eps=1e-6)
    want_losses, want_params = _jax_trajectory(flash, accum, batches, jcfg, jparams, tx_kw)

    model = Retriever(tcfg)
    model.load_state_dict(convert.params_from_jax(jparams))
    state = optim.init_train_state(dict(model.named_parameters()))
    tx = optim.AdamW(**tx_kw)
    gen = torch.Generator().manual_seed(0)
    for b, want in zip(batches, want_losses):
        state, m = train_step(model, state, tx, _torch_batch(b), gen, accum)
        assert abs(float(m["loss"]) - want) < TOL
    got = convert.params_to_jax({k: p.detach() for k, p in state.params.items()})
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want_params)):
        keys = tuple(p.key for p in path)
        # zero gradient in exact arithmetic (a constant added to every score
        # of a row): only rounding noise drives these, on both sides, and
        # Adam moves an element at most ~lr a step whatever the gradient
        noise_only = keys[-3:] == ("layers", "k", "bias") or keys == ("proj_c", "bias")
        atol = len(batches) * tx_kw["learning_rate"] if noise_only else TOL
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("flash", [True, False])
def test_head_bias_gradient_is_zero_in_both_packages(flash):
    """proj_c.bias's gradient is zero in exact arithmetic: a constant added to
    every context embedding moves each query's in-batch scores alike. On the
    step of tests/test_torch_cuda.py::test_train_step_on_gpu_matches_cpu
    (tiny f32 retriever, dropout 0, remat), with the same weights in both
    packages, the port's gradient and the JAX package's are each within
    ZERO_GRAD_ULPS f32 rounding units of their column sums of |dout| (the
    gradient at proj_c's output), and within that of each other: noise in
    both, not a fault of the port."""
    kw = dict(max_position_embeddings=128, flash_attention=flash, hidden_dropout=0.0,
              attention_dropout=0.0)
    jcfg = jax_bert.BertConfig.tiny(dtype=jnp.float32, **kw)
    jparams = jax.tree.map(np.asarray, init_retriever_params(jax.random.PRNGKey(4), jcfg))
    g = torch.Generator().manual_seed(4)
    batch = {"input_ids_q": torch.randint(5, 128, (8, 16), generator=g),
             "input_ids_c": torch.randint(5, 128, (8, 128), generator=g),
             "input_mask_q": torch.ones(8, 16, dtype=torch.int32)}
    batch["input_mask_c"] = (torch.arange(128)[None] < torch.arange(60, 124, 8)[:, None]).int()

    model = Retriever(BertConfig.tiny(dtype=torch.float32, remat=True, **kw)).train()
    model.load_state_dict(convert.params_from_jax(jparams))
    douts = []

    def keep_dout(module, args, out):  # returns None: the output stays as it is
        out.register_hook(douts.append)

    model.proj_c.register_forward_hook(keep_dout)
    in_batch_loss(model(batch, generator=torch.Generator().manual_seed(0)))[0].backward()
    bias_t = model.proj_c.bias.grad.detach()

    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()}
    out = retriever_forward(jparams, jcfg, jbatch)
    dout_j = jax.grad(lambda c: jax_trainer.in_batch_loss({"q": out["q"], "c": c})[0])(out["c"])
    grads = jax.grad(lambda p: jax_trainer.in_batch_loss(
        retriever_forward(p, jcfg, jbatch))[0])(jparams)
    bias_j = torch.tensor(np.asarray(grads["proj_c"]["bias"]))

    unit_t, unit_j = zero_grad_unit(douts[0]), zero_grad_unit(torch.tensor(np.asarray(dout_j)))
    assert unit_t > 0 and abs(unit_j / unit_t - 1) < 1e-5  # the same dout in both packages
    ratios = {"port": zero_grad_ratio(bias_t, unit_t), "jax": zero_grad_ratio(bias_j, unit_j),
              "port - jax": zero_grad_ratio(bias_t - bias_j, unit_t)}
    print(f"proj_c.bias gradient (flash={flash}) in units of {unit_t:.4e}: {ratios}")
    assert all(r <= ZERO_GRAD_ULPS for r in ratios.values()), ratios
    # the bound is not vacuous: the kernel's gradient (not zero) is far above it
    assert zero_grad_ratio(model.proj_c.kernel.grad, unit_t) > 100 * ZERO_GRAD_ULPS


@pytest.fixture
def deterministic():
    """PyTorch's CPU embedding backward accumulates in a varying order unless
    deterministic algorithms are on."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_remat_recompute_is_bit_equal(deterministic):
    """With dropout on, remat recomputes each layer's forward from the same
    seeds: every gradient equals the one without remat, bit for bit."""
    grads = []
    for remat, scope in ((False, "layer"), (True, "layer"), (True, "mlp")):
        cfg = BertConfig.tiny(dtype=torch.float32, max_position_embeddings=128,
                              flash_attention=True, remat=remat, remat_scope=scope)
        model = Retriever(cfg).reset_parameters(0).train()
        batch = _torch_batch(_toy_batches(1, 8, c_len=128, seed=4)[0])
        loss, _ = in_batch_loss(model(batch, generator=torch.Generator().manual_seed(5)))
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for other in grads[1:]:
        assert all(torch.equal(other[k], grads[0][k]) for k in grads[0])


def test_dropout_draws_seeds_and_eval_is_deterministic():
    cfg = BertConfig.tiny(dtype=torch.float32)
    model = Retriever(cfg).reset_parameters(0)
    batch = _torch_batch(_toy_batches(1, 4, seed=6)[0])
    with pytest.raises(ValueError, match="Generator"):
        model.train()(batch)
    a = model(batch, generator=torch.Generator().manual_seed(1))["c"]
    b = model(batch, generator=torch.Generator().manual_seed(1))["c"]
    c = model(batch, generator=torch.Generator().manual_seed(2))["c"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(batch)["q"], model(batch, generator=torch.Generator())["q"])


def _trainer(tmp_path, name, cfg=None, **kw):
    tcfg = RetrieverTrainerConfig(output_dir=str(tmp_path / name), **kw)
    return RetrieverTrainer(cfg or BertConfig.tiny(dtype=torch.float32), tcfg, device="cpu")


def test_trainer_full_loop_with_early_stop(tmp_path):
    trainer = _trainer(tmp_path, "run", learning_rate=1e-3, eval_period=2,
                       save_checkpoints_steps=4, num_train_epochs=2, wait_step=100, seed=1,
                       profile_dir=str(tmp_path / "trace"), profile_steps=2)
    train_b = _toy_batches(6, 16)
    eval_b = _toy_batches(2, 16, seed=7)
    best = trainer.train(lambda epoch: iter(train_b), lambda: iter(eval_b))
    assert 0.0 <= best <= 1.0
    for name in ("checkpoint_last.pt", "checkpoint_best.pt", "checkpoint_4.pt"):
        assert os.path.exists(tmp_path / "run" / name)
    assert latest_checkpoint(str(tmp_path / "run")).endswith("checkpoint_12.pt")
    lines = open(tmp_path / "run" / "metrics.jsonl").read().strip().splitlines()
    assert {"train_loss", "dev_acc", "step_p50_ms", "steps_per_s"} <= {
        json.loads(line)["tag"] for line in lines}
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0

    trainer2 = _trainer(tmp_path, "run", learning_rate=1e-3, seed=1)
    trainer2.resume(str(tmp_path / "run" / "checkpoint_last.pt"))
    assert trainer2.state.step == 12
    assert trainer2._resume_meta.get("best_acc") == best and "wait" in trainer2._resume_meta
    for k, p in trainer.state.params.items():
        assert torch.equal(trainer2.state.params[k], p)


def test_early_stop_writes_fired_countdown_to_meta(tmp_path):
    trainer = _trainer(tmp_path, "run", learning_rate=0.0, eval_period=1,
                       save_checkpoints_steps=10_000, num_train_epochs=1, wait_step=2, seed=2)
    trainer.train(lambda epoch: iter(_toy_batches(8, 16)),
                  lambda: iter(_toy_batches(1, 16, seed=7)))
    assert json.load(open(tmp_path / "run" / "trainer_meta.json"))["wait"] == 2


def test_resume_continues_training(tmp_path):
    """A resumed trainer continues with the restored moments: at dropout 0 its
    next step equals the uninterrupted run's, bit for bit."""
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)
    t1 = _trainer(tmp_path, "a", cfg, learning_rate=1e-3, eval_period=10_000,
                  save_checkpoints_steps=10_000, seed=4)
    batch = _toy_batches(1, 16)[0]
    for _ in range(3):
        t1.step(dict(batch))
    t1.save("checkpoint_last")
    saved = load_checkpoint(str(tmp_path / "a" / "checkpoint_last.pt"))
    assert saved.step == 3 and any(m.abs().sum() > 0 for m in saved.opt_state["mu"].values())

    t2 = _trainer(tmp_path, "a", cfg, learning_rate=1e-3, seed=5)
    t2.resume(str(tmp_path / "a" / "checkpoint_last.pt"))
    assert t2.state.step == 3
    assert all(torch.equal(t2.state.opt_state["nu"][k], v)
               for k, v in saved.opt_state["nu"].items())
    m1, m2 = t1.step(dict(batch)), t2.step(dict(batch))
    assert t2.state.step == 4 and float(m2["loss"]) == float(m1["loss"])
    assert all(torch.equal(t2.state.params[k], p) for k, p in t1.state.params.items())


def test_resume_completed_run_is_noop(tmp_path):
    kw = dict(learning_rate=0.0, eval_period=2, save_checkpoints_steps=10_000,
              num_train_epochs=2, wait_step=100, seed=3)
    trainer = _trainer(tmp_path, "run", **kw)
    trainer.train(lambda epoch: iter(_toy_batches(2, 16)),
                  lambda: iter(_toy_batches(1, 16, seed=7)))
    assert trainer.state.step == 4
    assert json.load(open(tmp_path / "run" / "trainer_meta.json"))["epoch"] == 2
    t2 = _trainer(tmp_path, "run", **kw)
    t2.resume(str(tmp_path / "run" / "checkpoint_last.pt"))
    t2.train(lambda epoch: iter(_toy_batches(2, 16)),
             lambda: iter(_toy_batches(1, 16, seed=7)))
    assert t2.state.step == 4


def test_resume_with_fired_countdown_stops_at_first_eval(tmp_path):
    kw = dict(learning_rate=0.0, eval_period=1, save_checkpoints_steps=10_000,
              num_train_epochs=1, wait_step=2, seed=2)
    trainer = _trainer(tmp_path, "run", **kw)
    trainer.train(lambda epoch: iter(_toy_batches(8, 16)),
                  lambda: iter(_toy_batches(1, 16, seed=7)))
    steps = trainer.state.step
    assert json.load(open(tmp_path / "run" / "trainer_meta.json"))["wait"] == 2
    t2 = _trainer(tmp_path, "run", **dict(kw, num_train_epochs=3))
    t2.resume(str(tmp_path / "run" / "checkpoint_last.pt"))
    t2.train(lambda epoch: iter(_toy_batches(8, 16)),
             lambda: iter(_toy_batches(1, 16, seed=7)))
    assert t2.state.step == steps + 1


@pytest.mark.parametrize("period", [-1, 0])
def test_trainer_eval_period_epoch_end_only(tmp_path, period):
    trainer = _trainer(tmp_path, f"run{period}", learning_rate=1e-3, eval_period=period,
                       save_checkpoints_steps=0, num_train_epochs=2, wait_step=100, seed=1)
    calls = []
    orig = trainer.evaluate
    trainer.evaluate = lambda it: (calls.append(1), orig(it))[1]
    best = trainer.train(lambda epoch: iter(_toy_batches(3, 16)),
                         lambda: iter(_toy_batches(2, 16, seed=7)))
    assert len(calls) == 2 and 0.0 <= best <= 1.0
    run = tmp_path / f"run{period}"
    assert os.path.exists(run / "checkpoint_best.pt")
    assert not any(p.name[11:-3].isdigit() for p in run.iterdir()
                   if p.name.startswith("checkpoint_"))


def test_trainer_epoch_end_eval_early_stop(tmp_path):
    trainer = _trainer(tmp_path, "run", learning_rate=0.0, eval_period=-1,
                       save_checkpoints_steps=0, num_train_epochs=10, wait_step=2, seed=1)
    calls = []
    orig = trainer.evaluate
    trainer.evaluate = lambda it: (calls.append(1), orig(it))[1]
    trainer.train(lambda epoch: iter(_toy_batches(2, 16)),
                  lambda: iter(_toy_batches(2, 16, seed=7)))
    assert len(calls) in (2, 3), len(calls)


def test_trainer_rejects_padded_train_batch(tmp_path):
    trainer = _trainer(tmp_path, "run", learning_rate=1e-3, eval_period=10, seed=1)
    batch = dict(_toy_batches(1, 16)[0], __rows__=12)
    with pytest.raises(ValueError, match="drop_last"):
        trainer.train(lambda epoch: iter([batch]), lambda: iter([]))


def test_training_learns_from_scratch(tmp_path):
    """The port of test_training_learns_and_shards without the mesh: a tiny
    f32 model with a larger init scale, dropout off, lr 1e-2, 200 steps on one
    batch, must fit it."""
    cfg = BertConfig.tiny(dtype=torch.float32, initializer_range=0.1, hidden_dropout=0.0,
                          attention_dropout=0.0)
    trainer = _trainer(tmp_path, "run", cfg, learning_rate=1e-2, eval_period=10_000,
                       save_checkpoints_steps=10_000, seed=0)
    batch = _toy_batches(1, 16)[0]
    losses = [float(trainer.step(dict(batch))["loss"]) for _ in range(200)]
    assert losses[-1] < 1.0, (losses[0], losses[-1])
    assert trainer.state.step == 200
    assert trainer.evaluate(iter([dict(batch, __rows__=16)])) > 0.8


def test_trainer_config_matches_jax_fields():
    jax_fields = {f.name for f in dataclasses.fields(jax_trainer.RetrieverTrainerConfig)}
    ours = {f.name for f in dataclasses.fields(RetrieverTrainerConfig)}
    assert ours == jax_fields - {"fast_prng"}  # the TPU's hardware-RNG switch
