"""Tests of the port that need the card: each Hopper kernel against its
plain PyTorch version on CUDA tensors, bit for bit, the wrappers'
launch counting, serving on the card against the CPU (the dense and
recurrent SMOKE configs, the chunked scans, the MoE FFN, the ring
cache written in place, and the encoder-decoder and the VLM with seeded
frames / patch embeddings), and
training the MoE family on the card (one step against the CPU's, and
its backward reproducible under ``RunConfig.deterministic``), the
recurrent families (the scans' gradients and one step against the
CPU's) and the encoder-decoder and the VLM (one step against the
CPU's), and serving the dense and MoE SMOKE configs on ("data",
"model") meshes — ranks sharing one card over gloo, and a card per rank
over NCCL — against the unsharded model on the CPU, and the loss and
gradient shards of one training step on such meshes against the CPU's.  They skip without a
CUDA device; on the card
run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
LANES = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, nbp1=40, S=57, seed=0):
    r = np.random.RandomState(seed)
    fb = (r.randn(nbp1, LANES) * np.exp(r.randn(nbp1, 1) * 4)) \
        .astype(np.float32)
    eb = r.randn(nbp1, LANES).astype(np.float32)
    fb[0] *= 1e-41
    eb[0] *= 1e-41
    fb[1] = eb[1] = 0.0
    fb[-1] = eb[-1] = 0.0
    perm = r.randint(0, nbp1, size=S).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (fb, eb, perm)]


PLAIN = {"int8": ref.quantize_int8_gather_ref, "int4": ref.ef_int4_gather_ref,
         "sign": ref.ef_sign_gather_ref}
#: k of the 25 / 10 / 1 % top-k rungs, all of which the main path runs
TOPK_KS = (256, 104, 16)


def _pairs(kind):
    """(kernel wrapper, plain version) pairs as f(fb, eb, perm, gamma)."""
    if kind == "topk":
        return [(lambda f, e, p, g, k=k: ops.gather_ef_topk(f, e, p, gamma=g,
                                                            k=k),
                 lambda f, e, p, g, k=k: ref.ef_topk_gather_ref(
                     f, e, p, gamma=g, k=k)) for k in TOPK_KS]
    kern, plain = getattr(ops, f"gather_ef_{kind}"), PLAIN[kind]
    return [(lambda f, e, p, g: kern(f, e, p, gamma=g),
             lambda f, e, p, g: plain(f, e, p, gamma=g))]


@pytest.mark.parametrize("kind", ["int4", "int8", "sign", "topk"])
def test_kernel_bit_exact_to_plain_version(dev, kind):
    for kern, plain in _pairs(kind):
        for seed in range(3):
            fb, eb, perm = _case(dev, seed=seed)
            for gamma in (1.0, 0.9, 0.6):
                got = kern(fb, eb, perm, gamma)
                want = plain(fb, eb, perm, gamma)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    b = b.reshape(a.shape)
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    assert torch.equal(a, b)


def test_launch_counts(dev):
    fb, eb, perm = _case(dev)
    ops.reset_launch_counts()
    ops.gather_ef_int8(fb, eb, perm, gamma=1.0)
    ops.gather_ef_int8(fb, eb, perm[:0], gamma=1.0)   # S = 0: no launch
    assert ops.launch_counts()["gather_ef_int8"] == 1


def _decode_case(dev, rows=37, k=104, seed=0):
    r = np.random.RandomState(seed)
    acc = (r.randn(rows, LANES) * np.exp(r.randn(rows, 1))).astype(
        np.float32)
    acc[1] = 0.0
    acc[2, ::3] *= np.float32(1e-41)
    acc[3, ::5] = np.float32(-0.0)
    s = (np.abs(r.randn(rows)) * 0.01).astype(np.float32)
    s[4], s[5] = 0.0, np.float32(3e-39)
    idx = np.stack([r.permutation(LANES)[:k] for _ in range(rows)])
    x = {"acc": acc, "s": s,
         "iacc": r.randint(-2 ** 31, 2 ** 31, (rows, LANES)).astype(np.int32),
         "q": r.randint(-127, 128, (rows, LANES)).astype(np.int8),
         "nib": r.randint(0, 256, (rows, LANES // 2)).astype(np.uint8),
         "sgn": r.randint(0, 256, (rows, LANES // 8)).astype(np.uint8),
         "mag": r.randn(rows).astype(np.float32),
         "imag": r.randint(-2 ** 31, 2 ** 31, rows).astype(np.int32),
         "qk": r.randint(-127, 128, (rows, k)).astype(np.int8),
         "idx": idx.astype(np.uint16)}
    return {n: torch.from_numpy(v).to(dev) for n, v in x.items()}


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("bits", [None, 16, 30])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_accum_bit_exact_to_plain_version(dev, kind, bits):
    """K5 / K6 (bits None) and K9 / K10 (fixed point) on the card."""
    x = _decode_case(dev)
    src = x["q"] if kind == "int8" else x["nib"]
    fn = getattr(ops, f"decode_accum_{kind}")
    for w in (0.37, 0.0, 1.0):
        wt = torch.tensor(w, device=dev)
        acc = x["acc"] if bits is None else x["iacc"]
        got = fn(acc, src, x["s"], wt, fixed_bits=bits)
        s2 = x["s"][:, None]
        if bits is None:
            plain = getattr(ref, f"dequant_accum_{kind}_ref")
            want = plain(acc, src, s2, wt)
        else:
            plain = getattr(ref, f"dequant_accum_{kind}_fp_ref")
            want = plain(acc, src, s2, wt, bits)
        torch.cuda.synchronize()
        assert _same(got, want)


@pytest.mark.parametrize("bits", [None, 16])
def test_sign_vote_accum_bit_exact_to_plain_version(dev, bits):
    """K7 (bits None) and K11 on the card."""
    x = _decode_case(dev)
    wt = torch.tensor(0.37, device=dev)
    if bits is None:
        got = ops.sign_vote_accum(x["acc"], x["mag"], x["sgn"], x["s"], wt)
        want = ref.sign_vote_accum_ref(x["acc"], x["mag"][:, None], x["sgn"],
                                       x["s"][:, None], wt)
    else:
        got = ops.sign_vote_accum(x["iacc"], x["imag"], x["sgn"], x["s"],
                                  wt, fixed_bits=bits)
        want = ref.sign_vote_accum_fp_ref(x["iacc"], x["imag"][:, None],
                                          x["sgn"], x["s"][:, None], wt,
                                          bits)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_scatter_accum_bit_exact_to_plain_version(dev, k):
    """K8 on the card, -0 and denormals in untouched lanes kept."""
    x = _decode_case(dev, k=k)
    wt = torch.tensor(0.37, device=dev)
    got = ops.topk_scatter_accum(x["acc"], x["qk"], x["idx"], x["s"], wt)
    want = ref.topk_scatter_accum_ref(x["acc"], x["qk"], x["idx"],
                                      x["s"][:, None], wt)
    torch.cuda.synchronize()
    assert _same(got, want)


def _flat_case(dev, rows=37, seed=0):
    r = np.random.RandomState(seed)
    g = (r.randn(rows, LANES) * np.exp(r.randn(rows, 1) * 4)) \
        .astype(np.float32)
    e = r.randn(rows, LANES).astype(np.float32)
    g[0] *= np.float32(1e-41)
    e[0] *= np.float32(1e-41)
    g[1] = e[1] = 0.0
    g[2, ::3] = e[2, ::5] = np.float32(-0.0)
    return [torch.from_numpy(x).to(dev) for x in (g, e)]


def _flat_pairs(kind):
    """(kernel wrapper, plain version) pairs of K12-K16 as f(g, e, gamma)
    on (rows, LANES) inputs; the wrappers take the flat buffers."""
    if kind == "int8":
        return [(lambda g, e, gm: ops.quantize_int8(
                    ref.ef_accumulate(g, e, gm).reshape(-1))[:3],
                 lambda g, e, gm: ref.quantize_int8_ref(
                    ref.ef_accumulate(g, e, gm)))]
    if kind == "dequant":
        def both(g, e, gm):
            q, s, _ = ref.quantize_int8_ref(ref.ef_accumulate(g, e, gm))
            s[3] = 3e-39
            return q, s
        return [(lambda g, e, gm: (ops.dequant_int8(
                    *both(g, e, gm), g.numel()),),
                 lambda g, e, gm: (ref.dequantize_int8_ref(
                    *both(g, e, gm)),))]
    if kind == "topk":
        return [(lambda g, e, gm, k=k: ops.ef_topk(
                    g.reshape(-1), e.reshape(-1), gamma=gm, k=k),
                 lambda g, e, gm, k=k: ref.ef_topk_select_ref(
                    g, e, gamma=gm, k=k)) for k in TOPK_KS]
    kern, plain = getattr(ops, f"ef_{kind}"), getattr(ref, f"ef_{kind}_ref")
    return [(lambda g, e, gm: kern(g.reshape(-1), e.reshape(-1),
                                   gamma=gm)[:3],
             lambda g, e, gm: plain(g, e, gamma=gm))]


@pytest.mark.parametrize("kind", ["int8", "int4", "sign", "topk", "dequant"])
def test_flat_kernel_bit_exact_to_plain_version(dev, kind):
    """K12-K16 on the card."""
    for kern, plain in _flat_pairs(kind):
        for seed in range(3):
            g, e = _flat_case(dev, seed=seed)
            for gamma in (1.0, 0.9, 0.6):
                got, want = kern(g, e, gamma), plain(g, e, gamma)
                torch.cuda.synchronize()
                assert all(_same(a, b) for a, b in zip(got, want))


def test_flat_launch_counts(dev):
    g, e = _flat_case(dev)
    ops.reset_launch_counts()
    ops.ef_sign(g.reshape(-1), e.reshape(-1), gamma=1.0)
    ops.ef_sign(g.reshape(-1)[:0], e.reshape(-1)[:0], gamma=1.0)  # no rows
    assert ops.launch_counts()["ef_sign"] == 1


#: one rung per codec of the ladder's kinds, leaf sizes no block multiple
RING_LEVELS = (("INT8", 1.0, 8), ("TOPK10", 0.10, 8), ("SIGN1", 1.0, 1),
               ("INT4", 1.0, 4), ("FULL", 1.0, 16), ("SKIP", 0.0, 0))
RING_SIZES = (6144 * 3 + 17, 8192, 8192, 6144, 2048, 700)


def _ring_pod(group):
    """One pod: a sync_tree round under the one-shot exchange and under
    the ring forced to 2 chunks; per plan the aggregate, the residuals,
    the bytes logged (gather + ring) and ``plan_wire_bytes`` of the
    gather rungs."""
    from repro_torch.core import planexec
    from repro_torch.core import sync as S
    from repro_torch.core.compression import Level
    from repro_torch.core.scheduler import SyncPlan

    P = group.size
    levels = tuple(Level(*x) for x in RING_LEVELS)
    omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
    plan = SyncPlan(tuple(range(len(levels))), levels, omega, 1)
    r = np.random.RandomState(11)
    tree = {f"p{i}": torch.from_numpy(
                r.randn(P, n).astype(np.float32)[group.rank]).to(group.device)
            for i, n in enumerate(RING_SIZES)}
    errs = {k: torch.full_like(v, 0.03) for k, v in tree.items()}
    out = {"backend": group.backend}
    for ring in (-1, 2):
        ep = planexec.build_exec_plan(plan, RING_SIZES, n_pods=P, ring=ring,
                                      device=group.device)
        group.log.clear()
        agg, ne = S.sync_tree(tree, errs, ep, gamma=0.9, pods=group)
        want = sum(lv.wire_bytes(s * 1024, P) for lv, s in
                   zip(ep.levels, ep.sig) if s and lv.codec.supports_ring)
        out[ring] = ({k: v.cpu().numpy() for k, v in agg.items()},
                     {k: v.cpu().numpy() for k, v in ne.items()},
                     group.bytes_logged("gather")
                     + group.bytes_logged("ring"), want)
    return out


def test_nccl_pods_ring_matches_one_shot(dev):
    """A card per pod (the NCCL pod group, up to 4 pods): the ring forced
    to 2 chunks gives the one-shot exchange's aggregate and residuals bit
    for bit, the same aggregate on every pod, and the bytes logged equal
    ``plan_wire_bytes`` of the gather rungs."""
    from repro_torch.launch.mesh import spawn_pods
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs a card per pod (two or more CUDA devices)")
    pods = spawn_pods(_ring_pod, min(n, 4), "cuda", timeout=600)
    for p, res in enumerate(pods):
        assert res["backend"] == "nccl"
        for ring in (-1, 2):
            agg, err, got, want = res[ring]
            assert got == want > 0, (p, ring)
            for k in agg:
                assert np.array_equal(agg[k].view(np.int32),
                                      pods[0][-1][0][k].view(np.int32))
                assert np.array_equal(err[k].view(np.int32),
                                      res[-1][1][k].view(np.int32))


def _hier_pod(group):
    """One member of a 2 x 2 fleet: the all-rungs sync_tree round under a
    two-tier plan (INT8 intra stage) with the cross tier one-shot and
    forced to 2 chunks, and under the bf16 intra stage; per plan the
    aggregate, the residuals and the bytes per tier, logged and priced."""
    from repro_torch.core import planexec
    from repro_torch.core import sync as S
    from repro_torch.core.compression import Level
    from repro_torch.core.scheduler import SyncPlan

    F = group.size
    levels = tuple(Level(*x) for x in RING_LEVELS)
    omega = tuple(float(x) for x in np.arange(1, F + 1) / (F * (F + 1) / 2))
    plan = SyncPlan(tuple(range(len(levels))), levels, omega, 1)
    r = np.random.RandomState(11)
    tree = {f"p{i}": torch.from_numpy(
                r.randn(F, n).astype(np.float32)[group.rank]).to(group.device)
            for i, n in enumerate(RING_SIZES)}
    errs = {k: torch.full_like(v, 0.03) for k, v in tree.items()}
    out = {"backend": group.backend}
    for hier, ring in ((2, -1), (2, 2), (1, -1)):
        ep = planexec.build_exec_plan(plan, RING_SIZES, n_pods=F,
                                      n_edge=group.n_edge, hier=hier,
                                      ring=ring, device=group.device)
        since = len(group.log)
        agg, ne = S.sync_tree(tree, errs, ep, gamma=0.9, pods=group)
        new = group.log[since:]
        cross = sum(x["bytes"] for x in new if x["tier"] != "intra")
        intra = sum(x["bytes"] for x in new if x["tier"] == "intra")
        out[(hier, ring)] = (
            {k: v.cpu().numpy() for k, v in agg.items()},
            {k: v.cpu().numpy() for k, v in ne.items()}, (cross, intra),
            (planexec.exec_wire_bytes(ep, F, n_cross=group.n_cross),
             planexec.exec_intra_bytes(ep, group.n_edge)), ep.hier)
    return out


def _check_hier_fleet(members, backend):
    for p, res in enumerate(members):
        assert res["backend"] == backend
        for key in ((2, -1), (2, 2), (1, -1)):
            agg, err, got, want, hier = res[key]
            assert any(hier), key
            assert tuple(got) == tuple(want) and min(want) > 0, (p, key)
            for k in agg:
                assert np.array_equal(
                    agg[k].view(np.int32),
                    members[0][key][0][k].view(np.int32)), (p, key, k)
        # the cross tier's ring gives the one-shot's bits
        for i in (0, 1):
            for k in res[(2, -1)][i]:
                assert np.array_equal(res[(2, 2)][i][k].view(np.int32),
                                      res[(2, -1)][i][k].view(np.int32))


def test_two_tier_sync_tree_on_one_card(dev):
    """Phase 8's two-tier sync_tree on one card: a 2 x 2 fleet of pods
    sharing it (gloo, staged): the aggregate the same on every member,
    the cross tier's 2-chunk ring bit-identical to its one-shot, the
    bytes per tier equal to the priced cross and intra bytes."""
    from repro_torch.launch.mesh import spawn_pods
    members = spawn_pods(_hier_pod, 4, "cuda", n_edge=2, timeout=600)
    _check_hier_fleet(members, "gloo" if torch.cuda.device_count() < 4
                      else "nccl")


def test_nccl_hier_fleet_matches_one_shot(dev):
    """A card per member of a 2 x 2 fleet (NCCL, with the intra and cross
    sub-groups made by ``dist.new_group``): as the one-card test."""
    from repro_torch.launch.mesh import spawn_pods
    if torch.cuda.device_count() < 4:
        pytest.skip("needs a card per fleet member (four CUDA devices)")
    members = spawn_pods(_hier_pod, 4, "cuda", n_edge=2, timeout=600)
    _check_hier_fleet(members, "nccl")


# ---------------------------------------------------------------------------
# serving (no kernel of its own: prefill and decode against the CPU)
# ---------------------------------------------------------------------------

#: served requests (prompt lengths; 8 new tokens each), one server batch
SERVE_PROMPTS = (40, 33, 17, 40)


def _served(model, requests_seed=2):
    """``model`` serving SERVE_PROMPTS: the tokens and every step's
    logits (f32, on the host)."""
    from repro_torch.launch import serve as tserve
    logs = []
    real_pre, real_dec = model.prefill, model.decode_step

    def rec(fn):
        def f(*a):
            logits, caches = fn(*a)
            logs.append(logits.float().cpu())
            return logits, caches
        return f

    model.prefill, model.decode_step = rec(real_pre), rec(real_dec)
    r = np.random.RandomState(requests_seed)
    reqs = [tserve.Request(i, r.randint(0, model.cfg.vocab_size, size=n)
                           .astype(np.int32), 8)
            for i, n in enumerate(SERVE_PROMPTS)]
    done = tserve.Server(model, 48, 4).serve(reqs)
    return [q.out_tokens for q in done], logs


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-8b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_serving_on_card_matches_cpu(dev, arch):
    """The SMOKE config served on the card and on the CPU from the same
    weights: in f32 every step's logits within 1e-4 relative and equal
    greedy tokens (gemma2: the local ring wraps at window 32); in bf16
    the prefill logits within 3e-2 relative norm."""
    import copy
    import dataclasses
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype, wdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype=dtype)
        host = tserve.init_model(cfg, "cpu", seed=1, dtype=wdt)
        card = copy.deepcopy(host).to(dev)
        card.device = dev
        (tc, lc), (th, lh) = _served(card), _served(host)
        if dtype == "float32":
            assert tc == th
            for a, b in zip(lc, lh):
                assert float((a - b).abs().max()) <= \
                    1e-4 * float(b.abs().max())
        else:
            a, b = lc[0], lh[0]
            assert float((a - b).norm() / b.norm()) < 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_apply_on_card_matches_cpu(dev, arch, dtype):
    """The MoE FFN on the card and on the CPU from the same inputs, at
    capacity factors 1.25 and 0.5: the dispatch (experts, rows, drops)
    equal; the output in f32 within 1e-4 relative, in bf16 within 3e-2
    relative norm."""
    import dataclasses
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    wdt = torch.float32 if dtype == "float32" else torch.bfloat16
    r = np.random.RandomState(0)
    for cf in (1.25, 0.5):
        cfg = dataclasses.replace(SMOKE_ARCHS[arch], capacity_factor=cf)
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff
        p = {"router": r.randn(D, E) * 0.02,
             "w_gate": r.randn(E, D, Fe) / np.sqrt(D),
             "w_up": r.randn(E, D, Fe) / np.sqrt(D),
             "w_down": r.randn(E, Fe, D) / np.sqrt(Fe)}
        host = {k: torch.from_numpy(v.astype(np.float32)).to(wdt)
                for k, v in p.items()}
        card = {k: v.to(dev) for k, v in host.items()}
        x = torch.from_numpy(r.randn(4, 48, D).astype(np.float32)).to(wdt)
        xf = x.reshape(-1, D)
        C = moe.capacity(xf.shape[0], cfg)
        logits = xf.float() @ host["router"].float()
        _, e_h, p_h, _ = moe.dispatch(xf, logits, cfg, C)
        _, e_c, p_c, _ = moe.dispatch(xf.to(dev), logits.to(dev), cfg, C)
        assert torch.equal(e_c.cpu(), e_h) and torch.equal(p_c.cpu(), p_h)
        a = moe.moe_apply(card, x.to(dev), cfg).float().cpu()
        b = moe.moe_apply(host, x, cfg).float()
        if dtype == "float32":
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        else:
            assert float((a - b).norm() / b.norm()) < 3e-2


def test_chunked_scans_on_card_match_cpu(dev):
    """The selective scan and the RG-LRU scan over 1024 positions (four
    chunks) on the card within 1e-5 relative of the CPU's (f32; the two
    devices round the same ops apart in the last bits)."""
    from repro_torch.models import mamba, rglru
    r = np.random.RandomState(0)
    B, S, Di, N = 2, 1024, 256, 16
    args = [r.randn(B, S, Di), np.log1p(np.exp(r.randn(B, S, Di))),
            -np.exp(r.randn(Di, N) * 0.5), r.randn(B, S, N),
            r.randn(B, S, N), r.randn(B, Di, N)]
    host = [torch.from_numpy(a.astype(np.float32)) for a in args]
    u, a, h0 = (torch.from_numpy(x.astype(np.float32)) for x in (
        r.randn(B, S, Di), 1 / (1 + np.exp(-r.randn(B, S, Di))),
        r.randn(B, Di)))
    for got, want in (
            (mamba.selective_scan_chunked(*(t.to(dev) for t in host)),
             mamba.selective_scan_chunked(*host)),
            (rglru.rglru_scan(u.to(dev), a.to(dev), h0.to(dev)),
             rglru.rglru_scan(u, a, h0))):
        for g, w in zip(got, want):
            assert g.is_cuda
            g = g.cpu()
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_scan_gradients_on_card_match_cpu(dev):
    """The gradients of every input of mamba's ``SelectiveScan`` (its
    chunk-recomputing backward) and of the RG-LRU scan (autograd) over
    1024 positions, seeded cotangents on y and hT, on the card within
    1e-5 of each leaf's largest magnitude of the CPU's (f32)."""
    from repro_torch.models import mamba, rglru
    r = np.random.RandomState(1)
    B, S, Di, N = 2, 1024, 256, 16
    cases = [(mamba.SelectiveScan.apply, [
        r.randn(B, S, Di), np.log1p(np.exp(r.randn(B, S, Di))),
        -np.exp(r.randn(Di, N) * 0.5), r.randn(B, S, N), r.randn(B, S, N),
        r.randn(B, Di, N)], [r.randn(B, S, Di), r.randn(B, Di, N)]),
        (rglru.rglru_scan, [r.randn(B, S, Di),
                            1 / (1 + np.exp(-r.randn(B, S, Di))),
                            r.randn(B, Di)],
         [r.randn(B, S, Di), r.randn(B, Di)])]
    for fn, args, cots in cases:
        grads = []
        for d in (dev, "cpu"):
            ins = [torch.tensor(a, dtype=torch.float32, device=d,
                                requires_grad=True) for a in args]
            outs = fn(*ins)
            grads.append(torch.autograd.grad(
                outs, ins, [torch.tensor(c, dtype=torch.float32, device=d)
                            for c in cots]))
        for g, w in zip(*grads):
            assert g.is_cuda
            assert float((g.cpu() - w).abs().max()) <= \
                1e-5 * float(w.abs().max())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_recurrent_training_step_on_card_matches_cpu(dev, arch):
    """One grad_sync step of a recurrent SMOKE config in f32 at 512
    positions (the scans' backward over two chunks) on the card (the
    kernels) and on the CPU (the plain versions) from the same state and
    batch: the loss within 1e-5 relative and the updated weights within
    1e-3 (chip_smoke.py phase 4's bound)."""
    _training_step_card_vs_cpu(dev, arch, 512)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_frontend_training_step_on_card_matches_cpu(dev, arch):
    """One f32 grad_sync step of the encoder-decoder's and the VLM's SMOKE
    configs at 64 positions, fed the pipeline's seeded non-zero frames /
    patch embeddings, card against CPU (the recurrent test's bounds)."""
    _training_step_card_vs_cpu(dev, arch, 64)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_frontend_serving_on_card_matches_cpu(dev, arch):
    """The encoder-decoder's and the VLM's SMOKE configs in f32, from the
    same weights on the card and on the CPU: a prefill with seeded
    non-zero frames / patch embeddings and 4 decode steps after it (the
    VLM's at n_patches + t), every step's logits within 1e-4 relative,
    and the cross K/V caches within 1e-4 too."""
    import copy
    import dataclasses
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    host = tserve.init_model(cfg, "cpu", seed=1, dtype=torch.float32)
    card = copy.deepcopy(host).to(dev)
    card.device = dev
    r = np.random.RandomState(2)
    toks = torch.from_numpy(r.randint(0, 256, size=(2, 44)).astype(np.int32))
    inputs = {k: torch.from_numpy((r.randn(*d) * 0.02).astype(np.float32))
              for k, d in host.frontend_shapes(2, 40).items()}
    outs = []
    for model in (card, host):
        P, logs = model.n_prefix, []
        with torch.inference_mode():
            logits, caches = model.prefill(
                toks[:, :40].to(model.device), P + 44,
                **{k: v.to(model.device) for k, v in inputs.items()})
            logs.append(logits.float().cpu())
            for t in range(40, 44):
                logits, caches = model.decode_step(
                    caches, P + t, toks[:, t:t + 1].to(model.device))
                logs.append(logits.float().cpu())
        outs.append((logs, {k: {n: c.float().cpu() for n, c in v.items()}
                            for k, v in caches.items()}))
    (lc, cc), (lh, ch) = outs
    for a, b in zip(lc, lh):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for part, kv in ch.items():
        for name, b in kv.items():
            a = cc[part][name]
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _training_step_card_vs_cpu(dev, arch, seq):
    """One f32 grad_sync step of ``arch``'s SMOKE config at ``seq``
    positions, card against CPU from the same state and batch: the loss
    within 1e-5 relative, the updated weights within 1e-3."""
    import dataclasses
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("s", seq, 2, "train"),
                    lr=1e-2, warmup_steps=1)
    card = Trainer(build_model(cfg, run, device=dev), run)
    host = Trainer(build_model(cfg, run, device="cpu"), run)
    states = [card.init_state(0)]
    states.append(convert.move_state(states[0], host))
    outs = []
    for tr, state in zip((card, host), states):
        batch = next(TokenPipeline(tr.model, run.shape, seed=1))
        plan = tr.scheduler.plan_from_levels(
            [i % 8 for i in range(len(tr.sizes))], (1.0,))
        state, m = tr.step(state, batch, plan, "grad_sync")
        outs.append((float(m["loss"]),
                     [p.detach().cpu() for p in T.leaves(state["params"])]))
    (lc, pc), (lh, ph) = outs
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    assert max(float((a - b).abs().max()) for a, b in zip(pc, ph)) <= 1e-3


def test_ring_write_decode_in_place_on_card(dev):
    """The decode write updates the stacked cache in place: the same
    storage, and no allocation; a decode step keeps every cache
    tensor's storage."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import serve as tserve
    from repro_torch.models import layers as L
    cache = torch.zeros((3, 4, 64, 2, 16), dtype=torch.bfloat16, device=dev)
    kv = torch.randn((4, 1, 2, 16), device=dev).to(torch.bfloat16)
    ptr = cache.data_ptr()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptrs = [L.ring_write_decode(cache[1], kv, t).data_ptr()
            for t in (0, 63, 64, 100)]
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    assert torch.cuda.max_memory_allocated() == base
    assert cache.data_ptr() == ptr and set(ptrs) == {cache[1].data_ptr()}
    for slot in (0, 63, 36):
        assert torch.equal(cache[1][:, slot], kv[:, 0])
    assert not cache[0].any() and not cache[1][:, 1:36].any()
    model = tserve.init_model(SMOKE_ARCHS["gemma2-9b"], dev, seed=0)
    with torch.inference_mode():
        toks = torch.randint(0, 256, (2, 40), device=dev)
        _, caches = model.prefill(toks, 48)
        ptrs = {(s, k): c.data_ptr() for s, kv_ in caches.items()
                for k, c in kv_.items()}
        _, caches2 = model.decode_step(caches, 40, toks[:, :1])
    assert caches2 is caches
    assert {(s, k): c.data_ptr() for s, kv_ in caches.items()
            for k, c in kv_.items()} == ptrs


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_training_step_on_card_matches_cpu(dev, arch):
    """One grad_sync step of the MoE SMOKE config in f32 on the card (the
    kernels) and on the CPU (the plain versions) from the same state and
    batch: the same top-k sets in every dispatch (the forward's and the
    backward's recompute), the loss within 1e-5 relative and the updated
    weights within 1e-3 (chip_smoke.py phase 4's bound)."""
    import dataclasses
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 2, "train"),
                    lr=1e-2, warmup_steps=1)
    card = Trainer(build_model(cfg, run, device=dev), run)
    host = Trainer(build_model(cfg, run, device="cpu"), run)
    states = [card.init_state(0)]
    states.append(convert.move_state(states[0], host))
    real = moe.dispatch
    outs = []
    for tr, state in zip((card, host), states):
        calls = []

        def rec(xf, logits, c, C, calls=calls):
            res = real(xf, logits, c, C)
            calls.append(res[1].sort(-1).values.cpu())
            return res
        batch = next(TokenPipeline(tr.model, run.shape, seed=1))
        plan = tr.scheduler.plan_from_levels(
            [i % 8 for i in range(len(tr.sizes))], (1.0,))
        moe.dispatch = rec
        try:
            state, m = tr.step(state, batch, plan, "grad_sync")
        finally:
            moe.dispatch = real
        outs.append((float(m["loss"]), calls,
                     [p.detach().cpu() for p in T.leaves(state["params"])]))
    (lc, rc, pc), (lh, rh, ph) = outs
    assert len(rc) == len(rh) == 2 * cfg.n_layers
    for a, b in zip(rc, rh):
        assert torch.equal(a, b)
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    assert max(float((a - b).abs().max()) for a, b in zip(pc, ph)) <= 1e-3


DETERMINISM_SCRIPT = r"""
import sys, torch
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.session import apply_determinism
from repro_torch.models.registry import build_model
import dataclasses
cfg = dataclasses.replace(SMOKE_ARCHS["qwen3-moe-30b-a3b"],
                          capacity_factor=0.5)
run = RunConfig(model=cfg, shape=ShapeConfig("s", 512, 8, "train"),
                deterministic=True)
apply_determinism(run)
model = build_model(cfg, run, device="cuda")
model.init_params(torch.Generator(device="cuda").manual_seed(0))
batch = next(TokenPipeline(model, run.shape, seed=1))
leaves = T.leaves(model.param_tree())
runs = []
for _ in range(2):
    loss = model.loss(batch)
    runs.append([g.clone() for g in torch.autograd.grad(loss, leaves)])
same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(*runs)]
print("SAME", all(same), sum(same), len(same))
"""


def test_moe_backward_bit_reproducible_under_deterministic(dev):
    """Under ``RunConfig.deterministic`` (``apply_determinism``, in a
    process of its own: the switch is process-wide and cuBLAS reads its
    workspace setting when it starts) the MoE SMOKE model's gradients at
    a capacity factor that drops pairs are the same bits twice."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    res = subprocess.run([sys.executable, "-c", DETERMINISM_SCRIPT],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SAME True" in res.stdout, res.stdout


# ---------------------------------------------------------------------------
# serving on a ("data", "model") mesh
# ---------------------------------------------------------------------------

#: the mesh cases' teacher-forced run: batch, prompt, decode steps
MESH_B, MESH_S, MESH_STEPS = 4, 16, 4


def _mesh_tokens():
    return torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, size=(MESH_B, MESH_S + MESH_STEPS)).astype(np.int32))


def _mesh_logits(model, ctx, toks):
    """Prefill and teacher-forced decode steps of ``model`` (sharded over
    ``ctx`` or whole): each step's last-position logits, whole, f32 on
    the host."""
    def whole(lg):
        lg = lg[:, -1]
        if ctx is not None:
            lg = ctx.gather_batch(ctx.all_gather(lg, "model", -1), MESH_B)
        return lg.float().cpu()
    toks = toks.to(model.device)
    with torch.inference_mode():
        lg, caches = model.prefill(toks[:, :MESH_S], MESH_S + MESH_STEPS)
        out = [whole(lg)]
        for i in range(MESH_STEPS):
            lg, caches = model.decode_step(
                caches, MESH_S + i, toks[:, MESH_S + i:MESH_S + i + 1])
            out.append(whole(lg))
    return torch.stack(out).numpy()


def _mesh_rank(ctx, arch):
    """One rank: ``arch``'s SMOKE config in f32 from seed 1 (CPU stream),
    sharded, on the rank's card; the whole logits and the Server's
    tokens, and the backend."""
    import dataclasses
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import serve as tserve
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    # drawn on the CPU (the card's generator is another stream), moved
    model = tserve.init_model(cfg, "cpu", seed=1, dtype=torch.float32,
                              ctx=ctx).to(ctx.device)
    model.device = ctx.device
    reqs = tserve.make_requests((16, 12, 9, 16), 6, 256, seed=2)
    done = tserve.Server(model, 22, MESH_B, ctx=ctx).serve(reqs)
    return (_mesh_logits(model, ctx, _mesh_tokens()),
            [r.out_tokens for r in done], ctx.world.backend)


def _mesh_want(arch, D, M):
    """The unsharded SMOKE model on the CPU (the MoE's blocks as the mesh
    dispatches them: ``moe_apply_blocked``)."""
    import dataclasses
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import serve as tserve
    from repro_torch.models import moe
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    model = tserve.init_model(cfg, "cpu", seed=1, dtype=torch.float32)
    real = moe.moe_apply
    moe.moe_apply = lambda p, x, c: moe.moe_apply_blocked(p, x, c, D, M)
    try:
        reqs = tserve.make_requests((16, 12, 9, 16), 6, 256, seed=2)
        done = tserve.Server(model, 22, MESH_B).serve(reqs)
        return (_mesh_logits(model, None, _mesh_tokens()),
                [r.out_tokens for r in done])
    finally:
        moe.moe_apply = real


def _check_mesh(res, want, D, M, backend):
    logits, tokens = want
    for got, toks, be in res:
        assert be == backend
        assert toks == tokens
        np.testing.assert_allclose(got, logits, rtol=1e-4,
                                   atol=1e-4 * np.abs(logits).max())


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["qwen3-8b", "dbrx-132b"])
def test_mesh_serving_on_one_card_matches_cpu(dev, arch, mesh):
    """D x M ranks sharing one card (gloo, staged through pinned host
    memory): the SMOKE config's logits, whole, within 1e-4 relative of
    the unsharded model's on the CPU (the MoE at capacity 1.25, each mesh
    block dispatched on its own), and every rank's Server tokens
    equal to it."""
    from repro_torch.launch.mesh import spawn_mesh
    res = spawn_mesh(_mesh_rank, *mesh, "cuda", args=(arch,), timeout=600)
    backend = "nccl" if mesh[0] * mesh[1] <= torch.cuda.device_count() \
        else "gloo"
    _check_mesh(res, _mesh_want(arch, *mesh), *mesh, backend)


def test_nccl_mesh_serving_matches_cpu(dev):
    """A card per rank (NCCL), dbrx-132b SMOKE on a (1, M) mesh of up to
    four cards: as the one-card test."""
    from repro_torch.launch.mesh import spawn_mesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs a card per rank (two or more CUDA devices)")
    M = min(n, 4)
    res = spawn_mesh(_mesh_rank, 1, M, "cuda", args=("dbrx-132b",),
                     timeout=600)
    _check_mesh(res, _mesh_want("dbrx-132b", 1, M), 1, M, "nccl")


# ---------------------------------------------------------------------------
# training on a ("data", "model") mesh
# ---------------------------------------------------------------------------


def _mesh_train_rank(ctx, case):
    from torch_mesh_train_ranks import model_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    return model_grads(ctx, *case), ctx.world.backend


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("case", [("qwen3-8b", 32, 4, None),
                                  ("dbrx-132b", 32, 4, 2.0)],
                         ids=["qwen3-8b", "dbrx-132b"])
def test_mesh_training_step_on_card_matches_cpu(dev, case, mesh):
    """One training step's loss and reduced gradient shards of a SMOKE
    config (f32; dbrx at capacity E / K) on D x M ranks sharing the card
    (or a card each) against the unsharded model on the CPU, within 1e-4
    of each leaf's largest entry."""
    from repro_torch import tree as T
    from repro_torch.launch.mesh import spawn_mesh
    from torch_mesh_train_ranks import model_case
    model, batch = model_case(*case)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, T.leaves(model.param_tree()))
    want = dict(zip((T.path_str(q) for q, _ in
                     T.leaves_with_path(model.param_tree())), grads))
    res = spawn_mesh(_mesh_train_rank, *mesh, "cuda", args=(case,),
                     timeout=600)
    for (got_loss, got), _ in res:
        assert abs(got_loss - float(loss)) <= 1e-4 * abs(float(loss))
        for path, (g, idx) in got.items():
            w = want[path].numpy()[idx]
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-12, \
                path
