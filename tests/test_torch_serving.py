"""The port's serving slice (``repro_torch.serving``) against ``repro``'s,
on the tiny bitnet-2b preset: greedy tokens of the port's ``ServeEngine``
over ``PagedKV`` against the reference's, plus the host-side pieces (API
validation, scheduler order, page pool, preemption, sampler).

The reference engine runs op by op (``jax.disable_jit()``), as in
``test_torch_model.py``: under ``jit`` XLA's excess bf16 precision moves the
logits by ~1e-2 and flips near-tied greedy picks."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch.train import reduce_config as j_reduce_config
from repro.models.transformer import Model as JModel
from repro.serving.api import RequestSpec as JRequestSpec
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.kv import PagedKV as JPagedKV
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import Model
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.gateway.scheduler import Scheduler
from repro_torch.serving.kv import PagedKV
from repro_torch.serving.paged_kv import PagedConfig, PagePool

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduce_config(j_get_config("bitnet-2b"), "tiny")
    jmodel = JModel(jcfg, mode="serve")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = reduce_config(get_config("bitnet-2b"), "tiny")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, Model(cfg, device="cpu"), params


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 1000, size=n)] for n in lens]


def _port_outputs(model, params, prompts, *, max_new=8, slots=2, n_pages=None,
                  samplings=None):
    eng = ServeEngine(model, params, max_slots=slots, max_len=64,
                      kv=PagedKV(page=8, n_pages=n_pages))
    samplings = samplings or [SamplingParams()] * len(prompts)
    reqs = [eng.submit(p, RequestSpec(max_new_tokens=max_new), sp)
            for p, sp in zip(prompts, samplings)]
    eng.run_until_drained()
    return [r.output for r in reqs], eng


def test_greedy_tokens_match_reference_engine(tiny):
    """Three requests on two slots (continuous batching, token-mode
    prefill), 8 greedy steps each: identical tokens."""
    jmodel, jparams, model, params = tiny
    prompts = _prompts(0, (5, 9, 13))
    jeng = JServeEngine(jmodel, jparams, max_slots=2, max_len=64, kv=JPagedKV(page=8))
    jreqs = [jeng.submit(p, JRequestSpec(max_new_tokens=8)) for p in prompts]
    with jax.disable_jit():
        jeng.run_until_drained()
    got, eng = _port_outputs(model, params, prompts)
    assert got == [r.output for r in jreqs]
    assert all(len(o) == 8 for o in got)
    assert eng.stats.completed == 3 and eng.stats.tokens_out == 24
    assert eng.stats.ticks == jeng.stats.ticks
    assert eng.pool.pages_free == eng.pool.cfg.n_pages


def test_preemption_keeps_greedy_tokens(tiny):
    """A pool too small for both slots forces preemption mid-decode; the
    victim replays its prompt plus output and the tokens are unchanged."""
    _, _, model, params = tiny
    prompts = _prompts(3, (14, 15))
    want, _ = _port_outputs(model, params, prompts, max_new=10)
    got, eng = _port_outputs(model, params, prompts, max_new=10, n_pages=5)
    assert eng.stats.preemptions > 0
    assert got == want


def test_seeded_sampling_reproducible_within_port(tiny):
    """Seeded draws depend on (seed, tokens generated) only: the same
    request gives the same tokens alone and beside other traffic."""
    _, _, model, params = tiny
    sp = SamplingParams(temperature=1.0, top_k=50, top_p=0.9, seed=1234)
    prompt = _prompts(4, (6,))[0]
    alone, _ = _port_outputs(model, params, [prompt], samplings=[sp], slots=3)
    busy, _ = _port_outputs(model, params, [prompt] + _prompts(5, (4, 7)), slots=3,
                            samplings=[sp, SamplingParams(temperature=0.7),
                                       SamplingParams(temperature=1.3, seed=9)])
    assert busy[0] == alone[0]
    greedy, _ = _port_outputs(model, params, [prompt])
    assert alone[0] != greedy[0]


def test_sampler_masks():
    """Greedy rows are argmax; top-k 1 and a tiny top-p collapse to it;
    every draw lies in its row's top-k set."""
    model = Model(reduce_config(get_config("bitnet-2b"), "tiny"), device="cpu")
    eng = ServeEngine(model, None, max_slots=4, max_len=32, kv=PagedKV(page=8))
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32))
    greedy = logits.argmax(-1)
    temps = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    top_k = np.array([0, 1, 0, 5], np.int32)
    top_p = np.array([1.0, 1.0, 1e-6, 1.0], np.float32)
    for step in range(20):
        out = eng._sample_fn(logits, temps, top_k, top_p, np.zeros(4, np.int64),
                             np.array([False, False, True, False]), np.full(4, step))
        assert out[:3].tolist() == greedy[:3].tolist()
        assert out[3].item() in logits[3].topk(5).indices.tolist()


def test_sampling_params_validation():
    for bad in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1), dict(seed=2**31),
                dict(spec_k=16)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    with pytest.raises(AttributeError):
        RequestSpec().max_new_tokens = 3          # frozen


def test_scheduler_priority_edf_and_victims():
    s = Scheduler()
    reqs = [Request(uid=i, prompt=[1], spec=RequestSpec(priority=p), deadline_s=dl,
                    t_admit=float(i))
            for i, (p, dl) in enumerate([(1, None), (0, 9.0), (0, 5.0), (1, 3.0)])]
    for r in reqs:
        assert s.push(r)
    assert [s.pop_next().uid for _ in range(4)] == [2, 1, 3, 0]
    for r in reqs:
        s.push(r)
    # an inadmissible head is bypassed, not a wedge
    assert s.pop_next(lambda r: r.uid != 2).uid == 1 and s.hol_bypasses == 1
    assert s.pick_victim([(0, reqs[0]), (1, reqs[1]), (3, reqs[3])]) == 3
    assert s.pick_victim([(1, reqs[1])], below_priority=0) is None


def test_page_pool_accounting():
    pool = PagePool(PagedConfig(n_layers=1, n_kv_heads=1, head_dim=4, page=4, n_pages=3),
                    max_slots=2, device=torch.device("cpu"))
    assert pool.k.shape == (1, 4, 1, 4, 4) and pool.scratch_page == 3
    pool.reserve(0, 5)
    assert len(pool.tables[0]) == 2 and pool.pages_free == 1
    t = pool.batch_tables([0], 3, 2)
    assert t[0, 2] == 3 and (t[1] == 3).all()
    with pytest.raises(MemoryError):
        pool.reserve(1, 9)
    pool.release(0)
    pool.release(1)
    assert pool.pages_free == 3


def test_engine_edges(tiny):
    _, _, model, params = tiny
    eng = ServeEngine(model, params, max_slots=1, max_len=32, kv=PagedKV(page=8))
    assert eng.submit([1, 2], RequestSpec(adapter_id="tenant-0")).state == "rejected"
    with pytest.raises(ValueError):
        eng.submit([])
    r1 = eng.submit([1, 2, 3], RequestSpec(max_new_tokens=3))
    r2 = eng.submit([4, 5], RequestSpec(max_new_tokens=3))
    eng.tick()
    # one slot: the second request waits for the first to finish
    assert (r1.state, r2.state) == ("running", "queued")
    eng.run_until_drained()
    assert (r1.state, r2.state) == ("done", "done")
    assert len(r1.output) == len(r2.output) == 3
    assert eng.pool.pages_free == eng.pool.cfg.n_pages


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--preset", "tiny", "--device", "cpu", "--requests", "3",
                           "--slots", "2", "--max-new", "3", "--kv", "paged", "--page", "8"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")][-1]
    out = json.loads(line[len("[serve] "):])
    assert out["completed"] == 3 and out["tokens_out"] == 9 and out["device"] == "cpu"
