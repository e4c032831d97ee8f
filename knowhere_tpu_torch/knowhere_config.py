"""KnowhereConfig — process-global runtime knobs.

Parity with the reference global config
(reference: include/knowhere/comp/knowhere_config.h:26-140,
src/common/comp/knowhere_config.cc). CPU-specific knobs (SIMD type, BLAS
threshold, AIO pool) map onto the port's equivalents:

- SetSimdType        -> set_distance_precision (EXACT f32 scan vs FAST scan kernels)
- thread pool sizes  -> query-chunk / tile sizes for the batched kernels
- EnablePatchForComputeFP32AsBF16 -> FAST precision mode
"""

from __future__ import annotations

from .ops.distances import DistancePrecision, get_distance_precision, set_distance_precision


class KnowhereConfig:
    _build_pool_size = 2
    _search_chunk = 4096
    _base_tile = 16384

    # --- precision / "simd type" --------------------------------------------
    @staticmethod
    def SetSimdType(simd_type: str) -> str:
        """Accepts the reference spellings (AUTO/AVX512/AVX2/SSE4_2/GENERIC/...)
        and maps them onto the scan precision: GENERIC -> EXACT (full-f32
        scan), anything vectorized/AUTO -> FAST (the scan kernels)."""
        st = simd_type.upper()
        if st in ("GENERIC", "REF", "EXACT"):
            set_distance_precision(DistancePrecision.EXACT)
        else:
            set_distance_precision(DistancePrecision.FAST)
        return st

    @staticmethod
    def EnablePatchForComputeFP32AsBF16() -> None:
        set_distance_precision(DistancePrecision.FAST)

    @staticmethod
    def DisablePatchForComputeFP32AsBF16() -> None:
        set_distance_precision(DistancePrecision.EXACT)

    @staticmethod
    def GetDistancePrecision() -> DistancePrecision:
        return get_distance_precision()

    # --- pool-size analogs -----------------------------------------------------
    @classmethod
    def SetBuildThreadPoolSize(cls, n: int) -> None:
        cls._build_pool_size = int(n)

    @classmethod
    def SetSearchThreadPoolSize(cls, n: int) -> None:
        # maps to the query-chunk width of the batched search kernels
        cls._search_chunk = max(1, int(n)) * 256

    @classmethod
    def GetBuildThreadPoolSize(cls) -> int:
        return cls._build_pool_size

    @classmethod
    def GetSearchThreadPoolSize(cls) -> int:
        return max(1, cls._search_chunk // 256)

    # --- clustering -------------------------------------------------------------
    _clustering_type = "kmeans"

    @classmethod
    def SetClusteringType(cls, t: str) -> None:
        cls._clustering_type = t

    @classmethod
    def GetClusteringType(cls) -> str:
        return cls._clustering_type

    # --- reference-parity knobs (knowhere_config.h:26-140) -----------------------
    # These map CPU/GPU runtime tuning onto this architecture where an analog
    # exists; pure CUDA/aio knobs are accepted and recorded so host code that
    # calls them keeps working (reference semantics: process-global settings).
    _blas_threshold = 16384
    _early_stop_threshold = 0.0
    _fetch_pool_size = 8
    _aio_pool_size = 0

    @classmethod
    def SetBlasThreshold(cls, n: int) -> None:
        cls._blas_threshold = int(n)

    @classmethod
    def GetBlasThreshold(cls) -> int:
        return cls._blas_threshold

    @classmethod
    def SetEarlyStopThreshold(cls, t: float) -> None:
        cls._early_stop_threshold = float(t)

    @classmethod
    def GetEarlyStopThreshold(cls) -> float:
        return cls._early_stop_threshold

    @classmethod
    def SetFetchThreadPoolSize(cls, n: int) -> None:
        cls._fetch_pool_size = int(n)

    @classmethod
    def GetFetchThreadPoolSize(cls) -> int:
        return cls._fetch_pool_size

    @classmethod
    def SetAioContextPool(cls, n: int) -> None:
        # DiskANN IO on this architecture is mmap/pread via numpy (no libaio);
        # the pool size is recorded for introspection only
        cls._aio_pool_size = int(n)

    @staticmethod
    def InitGPUResource(gpu_id: int = 0, res_num: int = 1) -> None:
        # tensors are placed by knowhere_tpu_torch.set_device; nothing to pre-allocate
        return None

    @staticmethod
    def FreeGPUResource() -> None:
        return None

    @staticmethod
    def SetRaftMemPool(init_mb: int = 0, max_mb: int = 0) -> None:
        return None

    @staticmethod
    def SettingRaftMemPool(init_mb: int = 0, max_mb: int = 0) -> None:
        return None

    @staticmethod
    def ShowVersion() -> str:
        from .feature import Version

        return f"knowhere_tpu_torch (index binary version {Version.CURRENT_VERSION})"
