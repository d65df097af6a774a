"""Point Transformer V3 on the port (`models/ptv3.py`, `ops/cuda/spconv.py`,
`ops/cuda/attn.py::attention_varlen`, `apps/segment.py`) against the
benchmark's plain reference (`benchmark/reference/ptv3.py`), at
`PTv3Config.tiny()` (heads of 16, all five stages, four blocks at stage 3 so
every order runs, patches of 48) on the CPU, with seeded weights whose
biases, BatchNorms and LayerNorms are not the identity.

The batch is four of the benchmark's room fragments cut to 600, 300, 90
and 40 points: stage 0 pads three of them to patches of 48 and leaves the
last one sequence of its own length; the deeper stages are single
sequences.  Orders, pooling clusters, neighbour maps and labels must equal
the reference's exactly; logits agree within LOGIT_TOL x max(1, |logit|):
both sides compute in float32, in other orders (the reference's Linear is
`F.linear`, its BatchNorm `F.batch_norm`, its SubMConv and attention
written out).  Then properties of the curves and the padding on their own.
"""

import numpy as np
import pytest
import torch

from benchmark.inputs.rooms_seg import fragment_pool
from benchmark.reference import ptv3 as ref
from graspnet_tpu_torch.apps.segment import Fragment, SegmentationPipeline
from graspnet_tpu_torch.config import PTv3Config
from graspnet_tpu_torch.models import init_weights
from graspnet_tpu_torch.models import ptv3
from graspnet_tpu_torch.ops.cuda import attn, build, spconv
from graspnet_tpu_torch.utils import tracing

LOGIT_TOL = 1e-5
LENGTHS = (600, 300, 90, 40)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state(cfg: PTv3Config, seed: int) -> dict:
    """Kaiming kernels (`init_weights`), then every bias, norm affine and
    BatchNorm statistic drawn away from zero and the identity."""
    model = init_weights(ptv3.PTv3(cfg), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    state = model.state_dict()
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "offset", "mean"):
            state[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif leaf in ("scale", "var"):
            state[k] = 1.0 + 0.2 * torch.rand(v.shape, generator=gen)
    return state


def fragments(seed: int = 2**31 + 3):
    pool = fragment_pool(seed, len(LENGTHS), max(LENGTHS))
    return [Fragment(c[:n], g[:n], f[:n]) for (c, g, f), n in zip(pool, LENGTHS)]


def batch_tensors(frags):
    grid = torch.from_numpy(np.concatenate([f.grid_coord for f in frags]).astype(np.int64))
    batch = torch.repeat_interleave(torch.arange(len(frags)), torch.tensor([len(f.grid_coord) for f in frags]))
    feat = torch.from_numpy(np.concatenate([f.feat for f in frags]))
    return grid, batch, feat


@pytest.fixture(scope="module")
def tiny_run():
    cfg = PTv3Config.tiny()
    state = seeded_state(cfg, 5)
    frags = fragments()
    pipe = SegmentationPipeline(cfg, params=state, device="cpu")
    handle = pipe.dispatch(frags)
    out = pipe.finish(handle)
    grid, batch, feat = batch_tensors(frags)
    want = ref.PTv3(ref.Config.from_fields(vars(cfg)), state, "cpu").forward(grid, batch, feat)
    return cfg, handle, out, want


def test_the_pipeline_matches_the_reference(tiny_run):
    cfg, handle, out, want = tiny_run
    logits = torch.from_numpy(np.concatenate([s.logits for s in out]))
    labels = torch.from_numpy(np.concatenate([s.labels for s in out]))
    assert [s.logits.shape for s in out] == [(n, cfg.num_classes) for n in LENGTHS]
    err = (logits - want["logits"]).abs().max().item()
    assert err <= LOGIT_TOL * max(1.0, want["logits"].abs().max().item()), err
    assert torch.equal(labels, torch.argmax(want["logits"], dim=1))
    assert ref.compare(logits, labels, want["logits"], 0.0)["label_diff"] == 0


def test_orders_clusters_and_maps_are_exact(tiny_run):
    cfg, handle, _, want = tiny_run
    got = {"stem": handle.stem,
           "stages": [{"order": st.order, "kmap": st.kmap, "cluster": st.cluster} for st in handle.stages]}
    assert len(handle.stages) == len(want["stages"]) == cfg.num_stages
    assert ref.order_diff(got, want) == 0
    for st, w in zip(handle.stages, want["stages"]):
        assert torch.equal(st.code, w["code"]) and torch.equal(st.inverse, w["inverse"])
        assert torch.equal(st.grid.long(), w["grid"]) and torch.equal(st.batch.long(), w["batch"])
    # the stages shrink, every fragment keeps points, and the deep stages are single sequences
    ns = [st.n for st in handle.stages]
    assert all(a > b for a, b in zip(ns, ns[1:])) and min(min(st.counts) for st in handle.stages) >= 1
    top = handle.stages[0].patches
    assert top.max_len == 48 and top.starts.tolist()[-1] > handle.stages[0].n  # the first three pad
    assert all(st.patches.sequences == len(LENGTHS) for st in handle.stages[2:])


def test_a_fault_in_each_mechanism_shows(tiny_run, monkeypatch):
    """The comparison sees a wrong order, cluster or map, and attention
    that ignores the patches."""
    cfg, handle, out, want = tiny_run
    stages = [{"order": st.order.clone(), "kmap": st.kmap.clone(), "cluster": st.cluster} for st in handle.stages]
    stages[1]["order"][2, :2] = stages[1]["order"][2, :2].flip(0)
    assert ref.order_diff({"stem": handle.stem, "stages": stages}, want) == 2
    stages = [{"order": st.order, "kmap": st.kmap, "cluster": st.cluster} for st in handle.stages]
    assert ref.order_diff({"stem": handle.stem[:, :-1], "stages": stages}, want) > 0
    monkeypatch.setattr(ptv3, "attention_varlen", lambda qkv, starts, heads, max_len: qkv[:, 2 * qkv.shape[1] // 3:])
    frags = fragments()
    bad = SegmentationPipeline(cfg, params=seeded_state(cfg, 5), device="cpu").segment(frags)
    logits = torch.from_numpy(np.concatenate([s.logits for s in bad]))
    assert (logits - want["logits"]).abs().max().item() > 1e-2


def test_spans_count_points_sequences_and_pairs(tiny_run):
    cfg, handle, _, want = tiny_run
    pipe = SegmentationPipeline(cfg, params=seeded_state(cfg, 5), device="cpu")
    timings = {}
    with tracing.recording() as rec:
        pipe.segment(fragments(), timings)
    spans = {s.name: s for s in rec.drain()}
    assert {"segment.dispatch", "segment.serialize", "segment.kmap", "segment.fetch"} <= set(spans)
    assert spans["segment.serialize"].counts["points"] == sum(LENGTHS)
    assert spans["segment.serialize"].counts["sequences"] == sum(st.patches.sequences for st in handle.stages)
    hits = int((want["stem"] >= 0).sum()) + sum(int((st["kmap"] >= 0).sum()) for st in want["stages"])
    assert spans["segment.kmap"].counts["pairs"] == hits
    assert spans["segment.serialize"].parent == spans["segment.dispatch"].id
    assert timings["segment"] >= timings["segment.dispatch"] > 0


def test_bad_batches_raise():
    pipe = SegmentationPipeline(PTv3Config.tiny(), device="cpu")
    frag = fragments()[3]
    with pytest.raises(ValueError, match="cells"):
        pipe.segment([Fragment(frag.coord, frag.grid_coord - 1, frag.feat)])
    with pytest.raises(ValueError, match="features"):
        pipe.segment([Fragment(frag.coord, frag.grid_coord, frag.feat[:, :3])])
    with pytest.raises(ValueError, match="fragments"):
        pipe.segment([])


# ------------------------------------------------------------- the curves --

def all_cells(d: int) -> torch.Tensor:
    r = torch.arange(1 << d)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("trans", [False, True])
def test_consecutive_hilbert_codes_are_face_neighbours(d, trans):
    g = all_cells(d)
    codes = ptv3.curve_codes(g, ["hilbert-trans" if trans else "hilbert"], d)[0]
    assert torch.equal(torch.sort(codes).values, torch.arange(8 ** d))
    path = g[torch.argsort(codes)]
    assert torch.equal((path[1:] - path[:-1]).abs().sum(dim=1), torch.ones(8 ** d - 1, dtype=torch.long))


@pytest.mark.parametrize("depth", [1, 5, 9, 16])
def test_codes_equal_the_reference_loops(depth):
    """Morton: bit i of x at 3i + 2, of y at 3i + 1, of z at 3i; the
    program's masks and Skilling's transform on words against the
    reference's bit loops and bit arrays."""
    gen = torch.Generator().manual_seed(depth)
    g = torch.randint(0, 1 << depth, (4000, 3), generator=gen)
    x, y, z = g.unbind(1)
    want_z = sum(((x >> i) & 1) << (3 * i + 2) | ((y >> i) & 1) << (3 * i + 1) | ((z >> i) & 1) << (3 * i)
                 for i in range(depth))
    got = ptv3.curve_codes(g, PTv3Config().order, depth)
    assert torch.equal(got[0], want_z)
    batch = torch.zeros(len(g), dtype=torch.long)
    for code, order in zip(got, PTv3Config().order):
        assert torch.equal(code, ref.encode(g, batch, depth, order)), order


def test_pooled_codes_are_the_coarser_curve():
    """A stage's codes >> 3 are the codes of its cells >> 1 at one bit
    less, for every order: pooling may shift instead of re-encoding."""
    g = torch.randint(0, 512, (3000, 3), generator=torch.Generator().manual_seed(1))
    fine = ptv3.curve_codes(g, PTv3Config().order, 9)
    assert torch.equal(fine >> 3, ptv3.curve_codes(g >> 1, PTv3Config().order, 8))


@pytest.mark.parametrize("counts,k", [((600, 300, 90, 40), 48), ((96, 48, 47, 49), 48), ((5,), 1024),
                                      ((1024, 1025, 3000), 1024)])
def test_the_padding_inverse_returns_every_point_once(counts, k):
    """Each order's scatter rows pick every real point's own slot once, the
    gathered rows hold each point, the padding repeats the patch before,
    and the sequences are the reference's `cu_seqlens`."""
    n = sum(counts)
    grid = torch.randint(0, 1 << 12, (n, 3), generator=torch.Generator().manual_seed(n))
    batch = torch.repeat_interleave(torch.arange(len(counts)), torch.tensor(counts))
    stage = ptv3.first_stage(grid, batch, counts, 12, PTv3Config().order)
    p = ptv3.patches(stage, k)
    pad, unpad, cu = ref.padding(batch, k)
    assert p.starts.tolist() == cu and p.max_len == max(min(c, k) for c in counts)
    for o in range(len(PTv3Config().order)):
        assert torch.equal(p.gather[o], stage.order[o][pad])
        assert torch.equal(torch.sort(p.scatter[o]).values, torch.sort(unpad).values)
        assert torch.equal(p.gather[o][p.scatter[o]], torch.arange(n))
        assert len(torch.unique(p.scatter[o])) == n


# ------------------------------------------------- the plain kernels' twins --

@pytest.mark.parametrize("k", [3, 5])
def test_kernel_map_plain_equals_the_reference(k):
    frags = fragments()
    grid, batch, _ = batch_tensors(frags)
    got, hits = spconv.kernel_map_plain(grid.int(), batch.int(), k)
    want = ref.neighbour_map(grid, batch, k)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    assert int(hits) == int((want >= 0).sum()) and torch.equal(got[:, k ** 3 // 2].long(), torch.arange(len(grid)))


def test_subm_conv_plain_equals_the_reference():
    frags = fragments()
    grid, batch, _ = batch_tensors(frags)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(len(grid), 16, generator=gen)
    kernel = torch.randn(27 * 16, 8, generator=gen)
    bias = torch.randn(8, generator=gen)
    kmap, _ = spconv.kernel_map_plain(grid.int(), batch.int(), 3)
    got = spconv.subm_conv_plain(x, kmap, kernel, bias)
    want = ref.subm_conv(x, ref.neighbour_map(grid, batch, 3), kernel, bias)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_attention_varlen_plain_equals_the_reference():
    gen = torch.Generator().manual_seed(4)
    qkv = torch.randn(200, 3 * 32, generator=gen)
    cu = [0, 48, 96, 130, 178, 200]
    got = attn.attention_varlen_plain(qkv, torch.tensor(cu, dtype=torch.int32), 2)
    want = ref.attention(qkv, cu, 2)
    assert (got - want).abs().max().item() <= 1e-6


def test_the_sparse_convolution_library_is_built_at_its_first_use_only():
    assert "spconv" not in build.SOURCES and "spconv" in build.LAZY
    assert build._source("spconv").exists() and build._source("spconv").parent == build.CSRC


def test_the_config_file_holds_the_published_sizes():
    from benchmark import harness

    spec = harness.load_json("configs", "ptv3m1-scannet-semseg.infer")
    assert spec["reduced"] == [] and spec["precision"] == "float32, TF32 off"
    assert ref.Config.from_fields(spec["model"]) == ref.Config.from_fields(vars(PTv3Config()))
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["model"].items() if k != "stride"}
    assert PTv3Config(**fields) == PTv3Config() and spec["model"]["stride"] == [2, 2, 2, 2]
    heads = [c // h for c, h in zip(PTv3Config().enc_channels + PTv3Config().dec_channels,
                                    PTv3Config().enc_num_head + PTv3Config().dec_num_head)]
    assert set(heads) == {16}
    n = sum(t.numel() for t in ptv3.PTv3(PTv3Config()).state_dict().values())
    assert 45e6 < n < 47e6, n


@pytest.mark.parametrize("preset", ["tiny", "published"])
def test_the_reference_derives_the_programs_weights_from_the_configuration(preset):
    """The reference's names and shapes come from the configuration's
    widths alone and are the program's state dict, entry for entry and in
    its order."""
    cfg = PTv3Config.tiny() if preset == "tiny" else PTv3Config()
    want = [(k, tuple(v.shape)) for k, v in ptv3.PTv3(cfg).state_dict().items()]
    assert list(ref.state_shapes(ref.Config.from_fields(vars(cfg))).items()) == want


@pytest.mark.parametrize("fault", ["qkv_bias_dropped", "stem_bias_added", "cpe_width", "mlp_width"])
def test_the_reference_refuses_weights_of_another_architecture(fault):
    """A program layer built at a wrong width, or with a bias missing or
    added, hands the reference weights it refuses before it computes."""
    cfg = PTv3Config.tiny()
    state = {k: v.clone() for k, v in ptv3.PTv3(cfg).state_dict().items()}
    if fault == "qkv_bias_dropped":
        del state["enc.0.blocks.0.qkv.bias"]
    elif fault == "stem_bias_added":
        state["embedding.conv.bias"] = torch.zeros(cfg.enc_channels[0])
    elif fault == "cpe_width":
        state["enc.1.blocks.0.cpe_conv.kernel"] = torch.zeros(8 * cfg.enc_channels[1], cfg.enc_channels[1])
    else:
        state["dec.0.blocks.0.fc1.kernel"] = torch.zeros(cfg.dec_channels[0], 2 * cfg.dec_channels[0])
    with pytest.raises(ValueError, match="names and shapes"):
        ref.PTv3(ref.Config.from_fields(vars(cfg)), state, "cpu")
