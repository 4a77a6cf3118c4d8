"""`repro_torch.api` — the port's programmatic surface.

    from repro_torch.api import Session
    s = Session.from_arch("qwen3-1.7b", smoke=False)
    s.train(steps=4, global_batch=2, seq_len=2048)
    s.serve(tokens=16)
    s.simulate(samples=65536, engine="jit")
    s.plan(gpu="v100", score="sim", engine="jit")
    s.predict(n_workers=4, gpu="v100")
"""
from repro_torch.api.events import Event, EventBus  # noqa: F401
from repro_torch.api.serving import ServeReport, generate  # noqa: F401
from repro_torch.api.session import (PredictionReport,  # noqa: F401
                                     Session)
