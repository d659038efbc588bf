"""The paper's own workload config: DRIM-ANN search over a SIFT100M-class
corpus (a copy of the JAX package's ``configs/drim_ann.py``, which
imports no framework).

Dataset shape mirrors §V-A: 100M uint8 points, D=128, 10k queries/batch,
nlist=2^16, M=16, CB=256, nprobe=96, recall@10 >= 0.8 regime.
``chip_smoke.py`` takes D, M, CB, k, the query batch, the duplication
budget and the code dtype from :func:`config`, and cuts N, nlist,
nprobe, split_max and tasks_per_shard to fit one card and run.
:func:`smoke_config` is the JAX package's reduced config of the same
family, field for field.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class DrimAnnConfig:
    n_points: int = 100_000_000
    dim: int = 128
    nlist: int = 65_536
    m: int = 16
    cb: int = 256
    nprobe: int = 96
    k: int = 10
    queries_per_batch: int = 10_000
    # layout/scheduler knobs (paper §IV)
    split_max: int = 4096
    dup_budget_frac: float = 0.10     # ~6 MB/DPU of 64 MB in the paper
    tasks_per_shard: int = 8192
    code_dtype: str = "uint8"


def config() -> DrimAnnConfig:
    return DrimAnnConfig()


def smoke_config() -> DrimAnnConfig:
    return DrimAnnConfig(n_points=8000, dim=32, nlist=64, m=8, cb=64,
                         nprobe=8, queries_per_batch=64, split_max=128,
                         tasks_per_shard=256)
