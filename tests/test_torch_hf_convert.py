"""HF / reference torch checkpoints into the port (models/hf_convert.py,
`convert-hf`): the port's state dict equals the JAX converter's tree through
models/convert.py:params_from_jax bit for bit, the converted encoder matches a
local-config `transformers.BertModel` (the tolerance of
tests/test_bert.py:test_hf_parity), and the CLI's `.pt` loads where every
checkpoint flag reads, as the same weights the `.npz` route gives."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proqa_tpu.models import hf_convert as jax_hf  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.models import hf_convert  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig, BertEncoder  # noqa: E402
from proqa_tpu_torch.models.convert import load_params, params_from_jax, save_npz  # noqa: E402
from proqa_tpu_torch.models.retriever import Retriever  # noqa: E402


def _hf_bert_state(cfg, rng, prefix=""):
    """An HF BertModel state dict of `cfg`'s shapes, from a numpy seed."""
    h, inter, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)

    state = {
        "embeddings.word_embeddings.weight": t(cfg.vocab_size, h),
        "embeddings.position_embeddings.weight": t(cfg.max_position_embeddings, h),
        "embeddings.token_type_embeddings.weight": t(cfg.type_vocab_size, h),
        "embeddings.LayerNorm.weight": 1 + t(h), "embeddings.LayerNorm.bias": t(h),
        "pooler.dense.weight": t(h, h), "pooler.dense.bias": t(h),
    }
    for i in range(n_l):
        base = f"encoder.layer.{i}."
        for name, (d_out, d_in) in {
            "attention.self.query": (h, h), "attention.self.key": (h, h),
            "attention.self.value": (h, h), "attention.output.dense": (h, h),
            "intermediate.dense": (inter, h), "output.dense": (h, inter),
        }.items():
            state[base + name + ".weight"] = t(d_out, d_in)
            state[base + name + ".bias"] = t(d_out)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[base + ln + ".weight"] = 1 + t(h)
            state[base + ln + ".bias"] = t(h)
    return {prefix + k: v for k, v in state.items()}


def _retriever_state(cfg, seed, ddp=True):
    """A reference BertForRetriever state dict (bert_q, bert_c, proj_q,
    proj_c), with DistributedDataParallel's `module.` prefix."""
    rng = np.random.default_rng(seed)
    state = {**_hf_bert_state(cfg, rng, "bert_q."), **_hf_bert_state(cfg, rng, "bert_c.")}
    for tower in ("proj_q", "proj_c"):
        state[f"{tower}.weight"] = torch.from_numpy(
            rng.standard_normal((128, cfg.hidden_size)).astype(np.float32) * 0.05)
        state[f"{tower}.bias"] = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    return {("module." if ddp else "") + k: v for k, v in state.items()}


def _equal_states(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


def test_retriever_state_matches_jax_converter():
    """A DDP-prefixed BertForRetriever state dict -> the port's Retriever
    state dict, bit-equal to the JAX converter's tree through
    params_from_jax, and loadable strictly."""
    cfg = BertConfig.tiny()
    state = _retriever_state(cfg, seed=0)
    got = hf_convert.retriever_params_from_state_dict(state, cfg)
    want = params_from_jax(jax_hf.retriever_params_from_state_dict(state, JaxBertConfig.tiny()))
    _equal_states(got, want)
    Retriever(cfg).load_state_dict(got)
    assert hf_convert.strip_ddp_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_bert_state_matches_jax_converter():
    cfg = BertConfig.tiny()
    state = _hf_bert_state(cfg, np.random.default_rng(1))
    got = hf_convert.bert_params_from_state_dict(state, cfg)
    _equal_states(got, params_from_jax(jax_hf.bert_params_from_state_dict(
        state, JaxBertConfig.tiny())))
    BertEncoder(cfg).load_state_dict(got)


def test_hf_parity():
    """Random-weight HF BertModel -> converter -> the port's encoder in f32:
    outputs match at tests/test_bert.py:test_hf_parity's tolerance."""
    transformers = pytest.importorskip("transformers")
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)
    hf_model = transformers.BertModel(transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, hidden_act="gelu"))
    hf_model.load_state_dict(_hf_bert_state(cfg, np.random.default_rng(2)), strict=False)
    hf_model.eval()
    ours = BertEncoder(cfg)
    ours.load_state_dict(hf_convert.bert_params_from_state_dict(hf_model.state_dict(), cfg))
    ours.eval()

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(5, cfg.vocab_size, size=(2, 12)))
    mask = torch.ones(2, 12, dtype=torch.int64)
    mask[1, 9:] = 0
    tt = torch.zeros_like(ids)
    tt[:, 6:] = 1
    with torch.no_grad():
        out = hf_model(input_ids=ids, attention_mask=mask, token_type_ids=tt)
        seq, pooled = ours(ids, mask, tt)
    m = mask[..., None].bool()
    np.testing.assert_allclose((seq * m).numpy(), (out.last_hidden_state * m).numpy(),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=2e-3, rtol=0)


def test_load_refuses_pickled_code_without_opt_in(tmp_path):
    """weights_only loading: a checkpoint holding an arbitrary object fails
    unless --allow-pickle opts in, which warns."""
    path = tmp_path / "legacy.pt"
    torch.save({"w": torch.ones(2), "obj": _Legacy()}, path)
    with pytest.raises(Exception):
        hf_convert.load_torch_checkpoint(str(path))
    with pytest.warns(UserWarning, match="allow-pickle"):
        state = hf_convert.load_torch_checkpoint(str(path), allow_pickle=True)
    assert torch.equal(state["w"], torch.ones(2))


class _Legacy:
    pass


def test_cli_convert_hf(tmp_path, capsys):
    """convert-hf --kind retriever and --kind bert write the port's `.pt`,
    which load_params reads as the same weights as the `.npz` of the JAX
    converter's tree; --output must be a .pt path."""
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n")
    cfg = BertConfig.tiny()
    state = _retriever_state(cfg, seed=4)
    torch.save(state, tmp_path / "ref.pt")
    common = ["--vocab", str(tmp_path / "vocab.txt"), "--tiny", "--device", "cpu"]
    torch_main(["convert-hf", *common, "--torch-checkpoint", str(tmp_path / "ref.pt"),
                "--kind", "retriever", "--output", str(tmp_path / "conv.pt")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "saved": str(tmp_path / "conv.pt"), "kind": "retriever"}
    save_npz(str(tmp_path / "conv.npz"),
             jax_hf.retriever_params_from_state_dict(state, JaxBertConfig.tiny()))
    _equal_states(load_params(str(tmp_path / "conv.pt")), load_params(str(tmp_path / "conv.npz")))

    bert = {k[len("module.bert_c."):]: v for k, v in state.items()
            if k.startswith("module.bert_c.")}
    torch.save({"module." + k: v for k, v in bert.items()}, tmp_path / "bert.pt")
    torch_main(["convert-hf", *common, "--torch-checkpoint", str(tmp_path / "bert.pt"),
                "--kind", "bert", "--output", str(tmp_path / "bert_conv.pt")])
    BertEncoder(cfg).load_state_dict(load_params(str(tmp_path / "bert_conv.pt")))
    with pytest.raises(SystemExit, match="a .pt path"):
        torch_main(["convert-hf", *common, "--torch-checkpoint", str(tmp_path / "ref.pt"),
                    "--output", str(tmp_path / "conv.msgpack")])
