"""Host copy of `srsran_tpu/runtime/state.py`, held to it by `tests/test_torch_stack.py`.

Checkpoint/resume for the streaming pipeline (SURVEY §5.4).

The reference's record-replay mechanism is I/Q capture files
(`filesource/filesink.c`, `ue_sync.c:743` file mode); the restartable
state is the per-carrier tracking state (timing cursor, CFO EMA, SFN) and
HARQ softbuffers. This module snapshots exactly that: a flat dict of
numpy arrays / scalars / nested dicts saved to one `.npz`, so a pipeline
can be stopped mid-stream and resumed deterministically on the same
capture file.

The port's `UeSync` keeps its buffer as a complex64 tensor on its device:
`ue_sync_state` reads it to the host and `restore_ue_sync` puts it back on
`sync.device`.  The snapshot is the reference's flat dict of numpy arrays
with the same keys and dtypes, so one `.npz` serves both packages and a
snapshot of either restores into the other.
"""

from __future__ import annotations

import json

import numpy as np

from ..device import as_samples


def _flatten(prefix: str, obj, out: dict):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}{k}/", v, out)
    elif isinstance(obj, np.ndarray):
        out[prefix[:-1]] = obj
    elif isinstance(obj, (int, float, str, bool, type(None))):
        out[prefix[:-1]] = np.array(json.dumps(obj))
    elif isinstance(obj, (list, tuple)):
        out[prefix[:-1]] = np.array(json.dumps(list(obj)))
    else:
        raise TypeError(f"unsupported state leaf at {prefix}: {type(obj)}")


def save_state(path: str, state: dict):
    flat: dict = {}
    _flatten("", state, flat)
    np.savez(path, **flat)


def load_state(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    out: dict = {}
    for key in data.files:
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        v = data[key]
        if v.dtype.kind == "U":  # JSON-encoded scalar or list
            d[parts[-1]] = json.loads(str(v))
        else:
            d[parts[-1]] = v
    return out


# --- UeSync snapshot hooks (the per-carrier pipeline state) ---------------


def ue_sync_state(sync) -> dict:
    """Snapshot a `phy.ue.ue_sync.UeSync` (timing cursor, CFO, cell)."""
    return {
        "state": sync.state,
        "buf": sync.buf.cpu().numpy().view(np.float32).copy(),
        "cfo": float(sync.cfo),
        "sf_idx": int(sync.sf_idx),
        "consumed": int(sync.consumed),
        "cell_id": -1 if sync.cell is None else int(sync.cell.id),
        "cell_prb": int(sync.cell_prb),
    }


def restore_ue_sync(sync, st: dict):
    from ..phy.common import Cell

    sync.state = st["state"]
    sync.buf = as_samples(np.asarray(st["buf"], np.float32).view(np.complex64), sync.device)
    sync.cfo = float(st["cfo"])
    sync.sf_idx = int(st["sf_idx"])
    sync.consumed = int(st["consumed"])
    if st["cell_id"] >= 0:
        sync.cell = Cell(nof_prb=int(st["cell_prb"]), nof_ports=1, id=int(st["cell_id"]))
    return sync
