"""The tensor-parallel plan (``launch.mesh.leaf_plan`` through
``launch.steps.tp_plan``) on meta shapes: for every arch of
``configs.registry.PORTED`` on both production meshes and on the three
meshes of tests/test_torch_distributed_train.py, each parameter's
decision against a table written here.

A leaf with a "T" placeholder is ``"split"`` where the resolved spec keeps
"model" on the dimension its layer splits (heads, MLP columns or rows,
experts, vocabulary), else ``"gathered"``; a leaf without one is
``"replicated"``.  The table lists the gathered leaves (a layer's view,
the superblock position left out), each for a reason the configs give:
the fused Mamba2 leaves always; at "model" = 16 query heads 40, 24, 56
and 20 (``fix_spec_for_shape`` moves "model" to head_dim), K / V heads
8 and 2, mamba2-130m's 24 SSD heads (``out_proj``'s 1,536 rows divide by
16, but not into whole heads of 64) and the vocabularies 50,280 and
51,866.  Also: ``attention.kv_heads`` (the K / V heads a rank's query
heads read where the K / V heads come whole), held against the GQA
grouping.
"""

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import PORTED
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models.common import tree_leaves

MESHES = {
    "production": t_mesh.make_production_mesh(),
    "production_pod": t_mesh.make_production_mesh(multi_pod=True),
    "data4": t_mesh.Mesh(("data", "model"), (4, 1)),
    "data2_model2": t_mesh.Mesh(("data", "model"), (2, 2)),
    "pod2_data2_model2": t_mesh.Mesh(("pod", "data", "model"), (2, 2, 2)),
}
PRODUCTION = ("production", "production_pod")

FUSED = {"layers/ssm/in_proj", "layers/ssm/conv_w", "layers/ssm/conv_b"}
KV = {"layers/attn/wk", "layers/attn/wv"}
HEADS = KV | {"layers/attn/wq", "layers/attn/wo"}
WHISPER_HEADS = {f"{stack}/{block}/{w}"
                 for stack, block in (("enc_layers", "attn"),
                                      ("dec_layers", "self_attn"),
                                      ("dec_layers", "cross_attn"))
                 for w in ("wq", "wk", "wv", "wo")}

#: arch -> the gathered leaves on the production meshes (model = 16)
GATHERED_16 = {
    "mamba2_130m": FUSED | {"layers/ssm/out_proj", "embed"},  # 24 heads, V
    "starcoder2_3b": HEADS,                   # H 24, KV 2
    "deepseek_coder_33b": HEADS,              # H 56, KV 8
    "qwen3_14b": HEADS,                       # H 40, KV 8
    "h2o_danube_1_8b": KV,                    # KV 8
    "jamba_v0_1_52b": FUSED | KV,             # KV 8
    "whisper_large_v3": WHISPER_HEADS | {"embed"},   # H = KV 20, V
    "llama4_scout_17b_a16e": HEADS,           # H 40, KV 8
    "llama4_maverick_400b_a17b": HEADS,       # H 40, KV 8
    "qwen2_vl_72b": KV,                       # KV 8
}


def expected(arch: str, mesh_name: str) -> set:
    """The gathered leaves: at "model" 1 and 2 every count divides, and
    only the fused Mamba2 leaves are gathered."""
    if mesh_name in PRODUCTION:
        return GATHERED_16[arch]
    return FUSED if "M" in get_config(arch).pattern() else set()


def view(path) -> str:
    """A leaf's path with the superblock position left out."""
    return "/".join(p for p in path if not p.startswith("pos"))


CASES = [(a, m, "full") for a in PORTED for m in MESHES] + \
    [(a, m, "smoke") for a in PORTED for m in MESHES if m not in PRODUCTION]


@pytest.mark.parametrize("arch,mesh_name,size", CASES,
                         ids=lambda v: str(v))
def test_plan_matches_table(arch, mesh_name, size):
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    mesh = MESHES[mesh_name]
    plan = dict(tree_leaves(steps.tp_plan(cfg, mesh)))
    holders = dict(tree_leaves(steps.model_module(cfg).param_specs(cfg)))
    assert set(plan) == set(holders)
    gathered = expected(arch, mesh_name)
    seen = set()
    for path, got in plan.items():
        if "T" not in holders[path]:
            want = "replicated"
        elif view(path) in gathered:
            want = "gathered"
            seen.add(view(path))
        else:
            want = "split"
        assert got == want, (path, got, want)
    assert seen == gathered


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_experts_split_on_the_largest_config(mesh_name):
    """llama4-maverick's 128 experts (400B parameters; the plan reads
    ParamDefs, no tensor is made) split over "model" = 16."""
    plan = steps.tp_plan(get_config("llama4_maverick_400b_a17b"),
                         MESHES[mesh_name])
    moe = plan["layers"]["pos1"]["moe"]
    assert [moe[w] for w in ("wi", "wg", "wo", "router")] == \
        ["split", "split", "split", "replicated"]
    assert moe["shared"]["wi"] == "split"


@pytest.mark.parametrize("spec,want", [
    (("data", "model", None), "split"),       # heads on "model"
    ((None, None, "model"), "gathered"),      # moved to head_dim
    (("data", None, None), "replicated"),     # "model" dropped
])
def test_leaf_plan_reads_the_spec(spec, want):
    m = MESHES["production"]
    assert t_mesh.leaf_plan(("layers", "pos0", "attn", "wq"), spec, m) \
        == want


@pytest.mark.parametrize("H,KV,size", [(32, 8, 16), (24, 8, 4),
                                       (12, 4, 6), (12, 3, 4), (8, 8, 2),
                                       (40, 8, 2)])
def test_kv_heads_serve_each_ranks_query_heads(H, KV, size):
    """Attention of a rank's query heads on the K / V heads ``kv_heads``
    picks equals those heads' rows of the whole attention."""
    g = torch.Generator().manual_seed(H * 100 + KV * 10 + size)
    q = torch.randn(1, 5, H, 4, generator=g)
    k, v = (torch.randn(1, 5, KV, 4, generator=g) for _ in range(2))
    whole = attn.sdpa(q, k, v)
    n = H // size
    for j in range(size):
        idx = attn.kv_heads(H, KV, size, j)
        assert n % len(idx) == 0
        got = attn.sdpa(q[:, :, j * n:(j + 1) * n], k[:, :, idx],
                        v[:, :, idx])
        torch.testing.assert_close(got, whole[:, :, j * n:(j + 1) * n],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", (2, 4))
def test_is_split_tells_a_rank_shard_from_a_whole_leaf(size):
    """``models.common.is_split``: a whole width is not split, the
    extent's share is, no ``tp`` is never, any other width raises."""
    from types import SimpleNamespace
    from repro_torch.models.common import is_split
    tp = SimpleNamespace(size=size)
    w = torch.empty(16, 24)
    assert not is_split(w, 24, 1, tp)
    assert not is_split(w, 96, 1, None)
    assert is_split(w, 24 * size, 1, tp)
    assert is_split(w, 16 * size, 0, tp)
    with pytest.raises(ValueError, match="neither whole"):
        is_split(w, 24 * size + 1, 1, tp)
