"""Sample pre-materialization: assemble once, train many (port of
goctr_tpu/data/pipeline.py; the npz files are the same, so either package
reads what the other wrote).

SQL + Python feature assembly is orders of magnitude slower than the card
consumes rows; the fix is to materialize the assembled TrainSample to disk
(an npz of x, y and the layout) and reuse it across runs, epochs and
models. Loading maps nothing fancy: the trainers take it from there.
"""
from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from goctr_tpu_torch.models.base import SampleInfo, TrainSample

log = logging.getLogger(__name__)


def save_sample(path: str | Path, sample: TrainSample) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, x=sample.x, y=sample.y,
             info=json.dumps({
                 "user_profile_range": sample.info.user_profile_range,
                 "user_behavior_range": sample.info.user_behavior_range,
                 "item_feature_range": sample.info.item_feature_range,
                 "ctx_feature_range": sample.info.ctx_feature_range,
             }))


def load_sample(path: str | Path) -> TrainSample:
    with np.load(path, allow_pickle=False) as z:
        info = json.loads(str(z["info"]))
        return TrainSample(
            x=z["x"], y=z["y"],
            info=SampleInfo(**{k: tuple(v) for k, v in info.items()}))


def materialize(rec_sys, ctx, cache_dir: str | Path,
                tag: Optional[str] = None, force: bool = False
                ) -> TrainSample:
    """get_sample with a disk cache keyed by (rec_sys class, tag)."""
    from goctr_tpu_torch.recommend.rcmd import get_sample

    cache_dir = Path(cache_dir)
    key = f"{type(rec_sys).__name__}-{tag or 'default'}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    path = cache_dir / f"sample-{digest}.npz"
    if path.exists() and not force:
        log.info("loading materialized sample %s", path)
        return load_sample(path)
    sample = get_sample(rec_sys, ctx)
    save_sample(path, sample)
    log.info("materialized %d x %d sample to %s", sample.rows,
             sample.x_cols, path)
    return sample
