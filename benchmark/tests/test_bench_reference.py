"""The plain references against the port's CPU paths at tiny sizes, and the
imports of every benchmark module."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import traffic as gen
from benchmark import weights as wts
from benchmark.drivers import encode, search
from benchmark.reference import bert as ref_bert
from benchmark.reference import dropout_bits
from benchmark.reference import search as ref_search

CPU = torch.device("cpu")
TINY = dict(vocab_size=1200, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=512, projection_dim=16)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "proqa_tpu"}
BENCH = harness.ROOT / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "proqa-bert-base.json").read_text())


def test_plain_search_equals_the_ports_cpu_search():
    n, d, k = 20_000, 64, 16
    index = search.build_index(3, n, d, CPU)
    queries = gen.query_pool(3, 1, 40, d)[0]
    vals, ids = index.search(queries, k)
    q = torch.from_numpy(queries).to(torch.bfloat16).float()
    want_v, want_i, scores = ref_search.topk_and_scores(
        q, gen.index_chunks(3, n, d, device=CPU, chunk_rows=7_000), k,
        torch.from_numpy(ids.astype(np.int64)))
    got = ref_search.compare(vals, ids.astype(np.int64), want_v, scores, n)
    assert got["bad_ids"] == 0 and got["score_gap"] <= 1e-6 and got["value_gap"] <= 1e-6
    assert (np.sort(ids, 1) == np.sort(want_i.numpy(), 1)).mean() > 0.99


def test_distinct_blocks_equal_the_ports_selection():
    from proqa_tpu_torch.ops.mips_kernel import select_blocks

    n, d, k, block = 20_003, 64, 8, 16   # a partial last block
    chunks = lambda: gen.index_chunks(3, n, d, device=CPU, chunk_rows=7_008)
    corpus = torch.cat([c for _, c in chunks()])
    corpus = torch.cat([corpus, corpus.new_zeros((-n) % block, d)])
    queries = torch.from_numpy(gen.query_pool(3, 2, 40, d)).to(torch.bfloat16)
    want = [int(torch.unique(select_blocks(b, corpus, k, block=block, n_valid=n)).numel())
            for b in queries]
    got = ref_search.distinct_blocks(queries.float(), chunks(), k, block, sub_rows=2_000 - 16)
    assert got == want and 2 * k < got[0] < 40 * k


def test_plain_tower_equals_the_ports_cpu_tower():
    cfg = {**CONFIG, **TINY}
    model = encode.build_model(4, cfg, CPU)
    rows = [[101] + list(range(1000, 1000 + n)) + [102] for n in (5, 17, 30)]
    ids = torch.zeros(3, 32, dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
    with torch.inference_mode():
        got = model.encode_context(ids, (ids != 0).to(torch.int32))
    want = ref_bert.embed_rows(rows, wts.retriever_weights(4, cfg, CPU), cfg, CPU)
    assert ref_bert.worst_gap(list(got), want) < 1e-4


def test_dropout_bits_equal_the_ports():
    from proqa_tpu_torch.ops import random

    for seed, stream, shape in ((7, 0, (3, 5, 8)), (2**61 + 3, 1, (2, 2, 9, 9))):
        want = random.keep_mask(seed, stream, 0.1, shape, CPU)
        assert torch.equal(dropout_bits.keep(seed, stream, 0.1, shape, CPU), want)


def test_weights_load_into_the_ports_retriever():
    from proqa_tpu_torch.models.retriever import Retriever

    cfg = {**CONFIG, **TINY}
    w = wts.retriever_weights(1, cfg, CPU)
    model = Retriever(encode.bert_config(cfg), cfg["projection_dim"])
    assert set(model.state_dict()) == set(w)
    model.load_state_dict(w)  # strict: every key and shape
    assert torch.equal(wts.retriever_weights(1, cfg, CPU)["proj_c.kernel"], w["proj_c.kernel"])


def test_traffic_sizes_do_not_depend_on_the_seed():
    tr = {"shard_rows": 2000, "pool": 1,
          "lengths": {"median": 120, "sigma": 0.7, "min": 16, "max": 512},
          "tokens": {"cls": 101, "sep": 102, "first_word": 999}}
    a, b = (gen.paragraph_shards(s, tr, 30522)[0] for s in (1, 2**40 + 9))
    assert sorted(map(len, a)) == sorted(map(len, b)) and a != b
    assert all(r[0] == 101 and r[-1] == 102 and 0 not in r for r in a)
    assert gen.stream_seed(-5, 1) != gen.stream_seed(5, 1)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_reference_free_of_the_program(path):
    names = _imports(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if path.parent.name == "reference":
        assert "proqa_tpu_torch" not in names


def test_forbidden_names_compare_whole_top_level_names():
    # the port's own name begins with the JAX package's and is allowed
    assert "proqa_tpu_torch".split(".")[0] not in FORBIDDEN
    assert harness.forbidden_modules() == []
