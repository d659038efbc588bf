"""Beyond-memory cluster storage: the tiered store (a resident slab on the
card over a CRC-checked spill on the host) and its residency policy."""

from repro_torch.storage.tiered import (CorruptClusterError,
                                        InjectedIOError,
                                        ResidencyController, TierStats,
                                        TieredStore, TieredStoreError)

__all__ = ["CorruptClusterError", "InjectedIOError", "ResidencyController",
           "TierStats", "TieredStore", "TieredStoreError"]
