"""The port's tensor-parallel compute along "model" for the enc-dec family
(``repro_torch/distributed/tensor_parallel.py``: the decoder's plan and
the encoder's, ``Route.cross_attention`` and ``Route.memory``;
``sharding.tp_layouts`` and ``tp_cache``) against the reference's
single-device steps.

The harness is ``tests/test_torch_tensor_parallel.py``'s, over this
file's cases, in a module fixture of its own: the reference runs once in a
subprocess, the port in 8 gloo processes, each under a limit of its own
(``torch_worlds``); the weights come from the reference's ``init``
through the weight bridge (``encdec_params_from_flat``), the batches,
frames and prompts are made with numpy from seeds.

Cases: a reduced whisper-tiny (2 + 2 layers, d 64, hd 16, d_ff 128, fp32)
(name -> (arch, reduced config, ("data", "model") mesh, training sequence
length)):
  * ``heads_local``: 4 heads on 2 KV heads on (4, 2), T 32, vocab 256:
    the encoder's and decoder's heads, the MLPs and the vocab local, the
    cross K/V the rank's KV head, both residuals sequence-parallel in
    training;
  * ``kv_replicated``: the same with vocab 250 (whole) on (2, 4): one
    query head a rank on its KV head, the cross K/V repeated as the self
    K/V are;
  * ``q_seq``: 3 heads on 1 KV head on (2, 4), T 32, ``enc_len`` 24 (which
    4 divides), remat "block": the decoder's and the encoder's query rows
    split (the encoder's against every key, its residual
    sequence-parallel in training), decode "kv_seq" on the cache of
    ``MAX_LEN`` 32, the cross K/V whole along "model";
  * ``whisper_at_16``: the same with ``enc_len`` 30 and vocab 250, which 4
    divides neither: the encoder "gathered", the vocab whole; whisper-tiny's
    plan at 16 ranks (1500 encoder positions, vocab 51865);
  * ``decoder_gathered``: the ``q_seq`` config at T 30: the decoder's
    training "gathered" (not sequence-parallel) beside an encoder whose
    residual is.
Each trains 3 AdamW steps, then serves a prefill (12 tokens and the
frames) and 8 greedy decode steps from the initial weights. In this
process: ``tp_cache``'s cross K/V layout for each decode plan.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tensor_parallel import (BATCH, DECODES, MAX_LEN, PROMPT,
                                        STEPS, TOL, make_inputs, reduced,
                                        run_reference, spawn_ranks)

WHISPER = dict(n_layers=2, n_enc_layers=2, d_model=64, vocab_size=256,
               d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16, enc_len=24)
THREE = dict(WHISPER, n_heads=3, n_kv_heads=1)      # neither divides 2 or 4
CASES = {"heads_local": ("whisper-tiny", WHISPER, (4, 2), 32),
         "kv_replicated": ("whisper-tiny", dict(WHISPER, vocab_size=250),
                           (2, 4), 32),
         "q_seq": ("whisper-tiny", dict(THREE, remat="block"), (2, 4), 32),
         "whisper_at_16": ("whisper-tiny", dict(THREE, enc_len=30,
                                                vocab_size=250), (2, 4), 32),
         "decoder_gathered": ("whisper-tiny", THREE, (2, 4), 30)}
LOCAL, KV_REPLICATED = ("local", [2, 1]), ("kv_replicated", [1, 1])
Q_SEQ, GATHERED, KV_SEQ = (("q_seq", [3, 1]), ("gathered", [3, 1]),
                           ("kv_seq", [3, 1]))
# each case's plan: the "model" size and the vocab (the MLPs are local in
# every case); the decoder's attention in training, whether its training
# is sequence-parallel, its prefill's and decode steps' modes; the
# encoder's attention (a train or prefill step's) and whether its training
# is sequence-parallel
PLANS = {"heads_local": (2, "local", LOCAL, True, LOCAL, LOCAL, LOCAL, True),
         "kv_replicated": (4, "whole", KV_REPLICATED, True, KV_REPLICATED,
                           KV_REPLICATED, KV_REPLICATED, True),
         "q_seq": (4, "local", Q_SEQ, True, Q_SEQ, KV_SEQ, Q_SEQ, True),
         "whisper_at_16": (4, "whole", Q_SEQ, True, Q_SEQ, KV_SEQ, GATHERED,
                           False),
         "decoder_gathered": (4, "local", GATHERED, False, Q_SEQ, KV_SEQ,
                              Q_SEQ, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the 8 ranks' records)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel_encdec")
    np.savez(tmp / "inputs.npz", **make_inputs(CASES, seed=31))
    run_reference(str(tmp / "inputs.npz"), str(tmp / "ref.npz"), CASES)
    ref = dict(np.load(tmp / "ref.npz"))
    inp = {**dict(np.load(tmp / "inputs.npz")),
           **{k: v for k, v in ref.items() if "/params/" in k}}
    np.savez(tmp / "port_inputs.npz", **inp)
    return ref, spawn_ranks(8, tmp, str(tmp / "port_inputs.npz"), CASES)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_reference(runs, name):
    """3 AdamW steps: losses and grad norms within 1e-5 relative of the
    reference's single-device step, every leaf (encoder, decoder,
    cross-attention) within 1e-5."""
    ref, ranks = runs
    rec = ranks[0]
    for i in range(STEPS):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(rec[f"{name}/{m}{i}"],
                                       ref[f"{name}/{m}{i}"], rtol=TOL)
    finals = sorted(k for k in ref if k.startswith(f"{name}/final"))
    assert finals and len(finals) == len(
        [k for k in rec if k.startswith(f"{name}/final")])
    for k in finals:
        np.testing.assert_allclose(rec[k], ref[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_serve_steps_match_reference(runs, name):
    """The prefill (frames and prompt) and 8 greedy decode steps of
    ``serve_step``: the logits gathered over the vocab (and the batch)
    within 1e-5 of the reference's ``prefill``/``decode``, the greedy
    tokens identical."""
    ref, ranks = runs
    rec = ranks[0]
    for j in range(DECODES + 1):
        np.testing.assert_allclose(rec[f"{name}/logits{j}"],
                                   ref[f"{name}/logits{j}"], atol=TOL,
                                   rtol=0, err_msg=f"step {j}")
    for j in range(DECODES):
        np.testing.assert_array_equal(rec[f"{name}/tokens{j}"],
                                      ref[f"{name}/tokens{j}"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_reports_the_same(runs, name):
    """The global metrics, the final leaves and the gathered logits are
    the same bits on every rank."""
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith(f"{name}/") and k.split(
        "/")[1].startswith(("loss", "grad_norm", "final", "logits"))]
    for rec in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_steps_take_the_plan(runs, name):
    """Each train step takes one route of the case's decoder plan with
    the encoder's under ``"encoder"``; the prefill one with the encoder's
    (never sequence-parallel), each decode step one without. Under "q_seq"
    rank i along "model" attends from rows [i n, (i + 1) n) of the
    decoder's text and of the encoder's positions, n each over the ranks;
    under "kv_seq" the serve steps carry the cache's ``MAX_LEN`` and rank
    i's positions, of which it wrote those below the prompt and decode
    steps. A rank's logits are its batch rows and, where the vocab is
    local, its vocab columns; its cross K is its data rows' and its KV
    head's where the heads split, else every KV head."""
    _, ranks = runs
    arch, over, (data, model), seq = CASES[name]
    m, vocab, train, sp, prefill, decode, enc, enc_sp = PLANS[name]
    cfg = reduced(arch, over)
    split = decode[0] == "kv_seq"
    per = MAX_LEN // model

    def rows(mode, n, r):
        return [n // m * r, n // m * (r + 1)] if mode == "q_seq" else None

    def want(heads, n, seq_parallel, r, kind):
        plan = {"model": m, "heads": heads[0], "local_heads": heads[1],
                "mlp": "local", "vocab": vocab, "seq_parallel": seq_parallel,
                "model_rank": r, "q_rows": rows(heads[0], n, r)}
        if heads[0] == "q_seq":
            plan["q_seq_heaviest_over_mean"] = (2 * m - 1) / m
        if kind != "train" and split:
            plan.update(cache_len=MAX_LEN, kv_rows=[per * r, per * (r + 1)])
        if kind != "decode":
            plan["encoder"] = {
                "heads": enc[0], "local_heads": enc[1], "mlp": "local",
                "seq_parallel": kind == "train" and enc_sp,
                "q_rows": rows(enc[0], cfg.enc_len, r)}
        return plan

    assert m == model
    for rank, rec in enumerate(ranks):
        r = rank % model
        assert json.loads(str(rec[f"{name}/train_plans"])) == [
            want(train, seq, sp, r, "train")] * STEPS
        assert json.loads(str(rec[f"{name}/serve_plans"])) == [
            want(prefill, PROMPT, False, r, "prefill")] + [
            want(decode, 1, False, r, "decode")] * DECODES
        if split:
            filled = PROMPT + DECODES - per * r
            assert rec[f"{name}/kv_written"].tolist() == [
                i < filled for i in range(per)]
        cols = cfg.vocab_size // (model if vocab == "local" else 1)
        assert list(rec[f"{name}/local_logits"]) == [BATCH // data, 1, cols]
        heads = (1 if train[0] in ("local", "kv_replicated")
                 else cfg.n_kv_heads)
        assert list(rec[f"{name}/local_cross_k"]) == [
            cfg.n_layers, BATCH // data, cfg.enc_len, heads, cfg.hd]


# ---------------------------------------------------------------------------
# the cross K/V's layout, in this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["heads_local", "kv_replicated", "q_seq"])
def test_tp_cache_lays_the_cross_kv_out_by_the_decode_plan(name):
    """``tp_cache`` gives the cross K/V the reference's spec where the
    heads are local (KV heads along "model"), the self K/V's repeated
    layout under "kv_replicated" (each KV head repeated for its ranks, the
    head dim sharded along "model"), and whole along "model" where the
    decode plan is "kv_seq" (the reference's spec shards ``head_dim``
    there), while the self K/V are split over their positions."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import build_model
    arch, over, shape, _ = CASES[name]
    cfg = reduced(arch, over)

    class Mesh:
        mesh_dim_names = ("data", "model")

    Mesh.shape = shape
    cache = build_model(cfg, device="cpu").init_cache(4, MAX_LEN)
    got, specs = shd.tp_cache(cfg, Mesh(), cache)
    want = shd.fit_tree(Mesh(), shd.cache_specs(cfg, Mesh()), cache)
    if name == "heads_local":
        assert specs == want and got["cross_k"] is cache["cross_k"]
        assert want["cross_k"] == shd.P(None, "data", None, "model", None)
    elif name == "kv_replicated":
        assert got["cross_k"].shape[3] == shape[1]
        assert torch.equal(got["cross_v"], cache["cross_v"].repeat_interleave(
            2, dim=3))
        assert specs["cross_k"] == shd.P(None, "data", None, "model", None)
        assert specs["k"] == specs["cross_k"]
    else:
        assert got["cross_k"] is cache["cross_k"]
        assert specs["cross_k"] == specs["cross_v"] == shd.P(
            None, "data", None, None, None)
        assert want["cross_k"] == shd.P(None, "data", None, None, "model")
        assert specs["k"] == shd.P(None, "data", "model", None, None)
