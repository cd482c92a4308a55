"""repro_torch.serve — cache-aware serving for diffusion on one GPU.

The layer that turns the executor machinery (segmented plans, adaptive
signature pools, serializable artifacts) into a system that drains
heterogeneous traffic::

    from repro_torch import serve
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor

    ex = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    store = serve.ArtifactStore(cfg, ex.solver, cfg_scale=1.5)
    store.add_policy("no_cache", "none")
    store.add_artifact("smooth", "dit_xl_ddim50.cache.json")   # validated

    engine = serve.ServeEngine(ex, params, store, max_batch=8)
    engine.submit(serve.Request(rid=0, seed=17, policy="smooth", label=3))
    results = engine.run_until_drained()       # {rid: numpy latent}
    print(engine.report())                     # p50/p95, throughput, variants

Pieces: :class:`Request`/:class:`RequestQueue` (real arrival timestamps,
virtual-clock test mode), :class:`MicroBatcher` (power-of-two buckets per
store entry), :class:`ArtifactStore` (strict-validated hot-reload, τ
ladders; serving never recalibrates), :class:`ServeEngine`
(step-interleaved scheduler over the executor's resumable runs) and
:class:`ServerMetrics` (queue wait vs service percentiles, model-call
variants, realized compute fraction).  The PyTorch port of the JAX
package's ``repro.serve``.
"""
from repro_torch.serve.batcher import (  # noqa: F401
    MicroBatch, MicroBatcher, bucket_for, bucket_sizes)
from repro_torch.serve.engine import (  # noqa: F401
    BatchRecord, SCHEDULERS, ServeEngine, batch_generator, batch_seed)
from repro_torch.serve.metrics import ServerMetrics, percentile  # noqa: F401
from repro_torch.serve.request import (  # noqa: F401
    Request, RequestQueue, VirtualClock, WallClock, poisson_arrivals)
from repro_torch.serve.store import (  # noqa: F401
    ArtifactStore, ServableEntry, TauLadder)
