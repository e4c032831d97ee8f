"""Declarative typed config system.

Reimplementation of the reference config machinery
(reference: include/knowhere/config.h:90-320 Entry descriptors + stage flags;
config.h:585-660 BaseConfig field list; src/common/config.cc FormatAndCheck/
Load producing precise Status codes invalid_param_in_json /
out_of_range_in_json / type_conflict_in_json / invalid_value_in_json /
invalid_metric_type, expected.h:38-41).

Usage:

    class IvfConfig(BaseConfig):
        nlist = Entry(int, default=128, range=(1, 65536), stages=[Stage.TRAIN])
        nprobe = Entry(int, default=8, range=(1, 65536),
                       stages=[Stage.SEARCH, Stage.ITERATOR])

    cfg = IvfConfig()
    status, msg = Config.load(cfg, {"nlist": 256, "metric_type": "L2"}, Stage.TRAIN)

Unknown JSON keys are ignored (reference behavior); numeric strings are
coerced the way the reference's FormatAndCheck does (it stringifies/parses
Milvus-provided params).
"""

from __future__ import annotations

import enum
import math
from typing import Any, Dict, List, Optional, Tuple, Type, Union

from .index_param import metric as metric_names
from .status import Status


class Stage(enum.Flag):
    TRAIN = enum.auto()
    SEARCH = enum.auto()
    RANGE_SEARCH = enum.auto()
    ITERATOR = enum.auto()
    FEDER = enum.auto()
    DESERIALIZE = enum.auto()
    DESERIALIZE_FROM_FILE = enum.auto()
    CLUSTER = enum.auto()
    STATIC = enum.auto()


ALL_STAGES = (
    Stage.TRAIN
    | Stage.SEARCH
    | Stage.RANGE_SEARCH
    | Stage.ITERATOR
    | Stage.FEDER
    | Stage.DESERIALIZE
    | Stage.DESERIALIZE_FROM_FILE
    | Stage.CLUSTER
    | Stage.STATIC
)

_UNSET = object()


class Entry:
    """One declarative config field (reference Entry<CFG_*>, config.h:90-200)."""

    __slots__ = (
        "name", "type", "default", "range", "stages", "allow_empty", "desc",
        "exclusive_hi",
    )

    def __init__(
        self,
        type_: type,
        default: Any = _UNSET,
        range: Optional[Tuple[float, float]] = None,  # noqa: A002 (parity name)
        stages: Union[Stage, List[Stage], None] = None,
        allow_empty: bool = False,  # "optional" in the reference
        desc: str = "",
        exclusive_hi: bool = False,  # half-open [lo, hi) range (e.g. drop_ratio)
    ):
        self.name: str = ""  # filled by ConfigMeta
        self.type = type_
        self.default = default
        self.range = range
        self.exclusive_hi = exclusive_hi
        if stages is None:
            st = ALL_STAGES
        elif isinstance(stages, Stage):
            st = stages
        else:
            st = Stage(0)
            for s in stages:
                st |= s
        self.stages = st
        self.allow_empty = allow_empty or default is _UNSET
        self.desc = desc

    def has_default(self) -> bool:
        return self.default is not _UNSET

    def for_stage(self, stage: Stage) -> bool:
        return bool(self.stages & stage)

    def coerce(self, value: Any) -> Tuple[Any, Status, str]:
        """Coerce a JSON value to this entry's type, reference-style."""
        t = self.type
        try:
            if t is bool:
                if isinstance(value, bool):
                    return value, Status.success, ""
                if isinstance(value, str):
                    lv = value.strip().lower()
                    if lv in ("true", "1"):
                        return True, Status.success, ""
                    if lv in ("false", "0"):
                        return False, Status.success, ""
                if isinstance(value, (int, float)) and value in (0, 1):
                    return bool(value), Status.success, ""
                return None, Status.type_conflict_in_json, f"{self.name}: expected bool, got {value!r}"
            if t is int:
                if isinstance(value, bool):
                    return None, Status.type_conflict_in_json, f"{self.name}: expected int, got bool"
                if isinstance(value, int):
                    return value, Status.success, ""
                if isinstance(value, float):
                    if value.is_integer():
                        return int(value), Status.success, ""
                    return None, Status.type_conflict_in_json, f"{self.name}: expected int, got {value!r}"
                if isinstance(value, str):
                    sv = value.strip()
                    try:
                        f = float(sv)
                    except ValueError:
                        return None, Status.type_conflict_in_json, f"{self.name}: expected int, got {value!r}"
                    if not f.is_integer():
                        return None, Status.type_conflict_in_json, f"{self.name}: expected int, got {value!r}"
                    return int(f), Status.success, ""
                return None, Status.type_conflict_in_json, f"{self.name}: expected int, got {type(value).__name__}"
            if t is float:
                if isinstance(value, bool):
                    return None, Status.type_conflict_in_json, f"{self.name}: expected float, got bool"
                if isinstance(value, (int, float)):
                    return float(value), Status.success, ""
                if isinstance(value, str):
                    try:
                        return float(value.strip()), Status.success, ""
                    except ValueError:
                        return None, Status.type_conflict_in_json, f"{self.name}: expected float, got {value!r}"
                return None, Status.type_conflict_in_json, f"{self.name}: expected float, got {type(value).__name__}"
            if t is str:
                if isinstance(value, str):
                    return value, Status.success, ""
                return None, Status.type_conflict_in_json, f"{self.name}: expected string, got {type(value).__name__}"
            # dict / list / passthrough entries (e.g. materialized_view_search_info)
            return value, Status.success, ""
        except Exception as e:  # pylint: disable=broad-except
            return None, Status.invalid_value_in_json, f"{self.name}: {e}"

    def check_range(self, value: Any) -> Tuple[Status, str]:
        if self.range is None or value is None:
            return Status.success, ""
        lo, hi = self.range
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            too_high = hi is not None and (
                value >= hi if self.exclusive_hi else value > hi
            )
            if (lo is not None and value < lo) or too_high:
                hi_s = "inf" if hi is None or math.isinf(hi) else hi
                close = ")" if self.exclusive_hi else "]"
                return (
                    Status.out_of_range_in_json,
                    f"Param '{self.name}'({value}) is not in range [{lo}, {hi_s}{close}",
                )
        return Status.success, ""


class ConfigMeta(type):
    """Collects Entry declarations across the MRO into `_entries`."""

    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        entries: Dict[str, Entry] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Entry):
                    v.name = k
                    entries[k] = v
        cls._entries = entries
        return cls


class Config(metaclass=ConfigMeta):
    _entries: Dict[str, Entry] = {}

    def __init__(self) -> None:
        # every field starts unset (None); defaults applied per-stage at load
        for k in self._entries:
            object.__setattr__(self, k, None)

    @classmethod
    def entries(cls) -> Dict[str, Entry]:
        return cls._entries

    def get(self, key: str, default: Any = None) -> Any:
        v = getattr(self, key, None)
        return default if v is None else v

    # ------------------------------------------------------------------
    @staticmethod
    def format_and_check(cfg: "Config", json_cfg: Dict[str, Any]) -> Tuple[Status, str]:
        """Pre-parse validation of raw JSON (reference Config::FormatAndCheck).

        Checks that values for known keys are type-coercible. Unknown keys are
        ignored (host systems pass extra fields through).
        """
        if not isinstance(json_cfg, dict):
            return Status.invalid_param_in_json, "config must be a JSON object"
        for key, raw in json_cfg.items():
            ent = cfg._entries.get(key)
            if ent is None:
                continue
            if raw is None:
                continue
            _, st, msg = ent.coerce(raw)
            if st != Status.success:
                return st, msg
        return Status.success, ""

    @staticmethod
    def load(cfg: "Config", json_cfg: Dict[str, Any], stage: Stage) -> Tuple[Status, str]:
        """Apply defaults + user values for one stage, with validation."""
        st, msg = Config.format_and_check(cfg, json_cfg)
        if st != Status.success:
            return st, msg
        for key, ent in cfg._entries.items():
            if not ent.for_stage(stage):
                continue
            raw = json_cfg.get(key, _UNSET)
            if raw is _UNSET or raw is None:
                if getattr(cfg, key, None) is None and ent.has_default():
                    object.__setattr__(cfg, key, ent.default)
                if getattr(cfg, key, None) is None and not ent.allow_empty:
                    return (
                        Status.invalid_param_in_json,
                        f"Param '{key}' is required for this operation but missing",
                    )
                continue
            val, st, msg = ent.coerce(raw)
            if st != Status.success:
                return st, msg
            st, msg = ent.check_range(val)
            if st != Status.success:
                return st, msg
            object.__setattr__(cfg, key, val)
        # post checks
        return cfg.check_and_adjust(stage)

    # Subclasses override for cross-field validation (reference CheckAndAdjust)
    def check_and_adjust(self, stage: Stage) -> Tuple[Status, str]:  # noqa: ARG002
        return Status.success, ""

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._entries if getattr(self, k) is not None}


# ---------------------------------------------------------------------------
# BaseConfig — the ~50 common fields (reference config.h:585-660; defaults and
# ranges per SURVEY.md Appendix A).
# ---------------------------------------------------------------------------

_FLOAT_MAX = float("inf")
# Sentinel meaning "range_filter unset" (reference config.h:583
# defaultRangeFilter = 1.0f/0.0f): when equal to this, only the radius bound
# applies; when set, the two-sided [range_filter, radius) / (radius,
# range_filter] window applies (config.h:596-597).
DEFAULT_RANGE_FILTER = _FLOAT_MAX


class BaseConfig(Config):
    metric_type = Entry(
        str,
        default="L2",
        stages=[Stage.TRAIN, Stage.SEARCH, Stage.RANGE_SEARCH, Stage.ITERATOR, Stage.STATIC, Stage.CLUSTER, Stage.DESERIALIZE, Stage.DESERIALIZE_FROM_FILE],
        desc="metric type",
    )
    dim = Entry(int, range=(1, None), stages=[Stage.TRAIN, Stage.STATIC], allow_empty=True)
    k = Entry(int, default=10, range=(1, None), stages=[Stage.SEARCH], desc="topk")
    num_build_thread = Entry(int, range=(1, None), stages=[Stage.TRAIN], allow_empty=True)
    radius = Entry(float, default=0.0, stages=[Stage.RANGE_SEARCH])
    range_search_k = Entry(
        int, default=-1, range=(-1, None), stages=[Stage.RANGE_SEARCH],
        desc="limit the number of range-search results; -1 = unlimited",
    )
    range_filter = Entry(float, default=DEFAULT_RANGE_FILTER, stages=[Stage.RANGE_SEARCH])
    range_search_level = Entry(float, default=0.01, range=(0.0, 0.5), stages=[Stage.RANGE_SEARCH])
    retain_iterator_order = Entry(bool, default=False, stages=[Stage.ITERATOR])
    iterator_refine_ratio = Entry(float, default=0.5, range=(0.0, 1.0), stages=[Stage.ITERATOR])
    trace_visit = Entry(bool, default=False, stages=[Stage.FEDER])
    enable_mmap = Entry(bool, default=False, stages=[Stage.DESERIALIZE_FROM_FILE, Stage.DESERIALIZE])
    enable_mmap_pop = Entry(bool, default=False, stages=[Stage.DESERIALIZE_FROM_FILE])
    shuffle_build = Entry(bool, default=True, stages=[Stage.TRAIN])
    trace_id = Entry(str, stages=[Stage.SEARCH, Stage.RANGE_SEARCH, Stage.ITERATOR], allow_empty=True)
    span_id = Entry(str, stages=[Stage.SEARCH, Stage.RANGE_SEARCH, Stage.ITERATOR], allow_empty=True)
    trace_flags = Entry(int, stages=[Stage.SEARCH, Stage.RANGE_SEARCH, Stage.ITERATOR], allow_empty=True)
    materialized_view_search_info = Entry(dict, stages=[Stage.SEARCH, Stage.RANGE_SEARCH], allow_empty=True)
    opt_fields_path = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    data_path = Entry(str, stages=[Stage.TRAIN], allow_empty=True)
    index_prefix = Entry(str, allow_empty=True)
    # BM25 params (sparse; config.h BaseConfig)
    bm25_k1 = Entry(float, range=(0.0, 3.0), allow_empty=True)
    bm25_b = Entry(float, range=(0.0, 1.0), allow_empty=True)
    bm25_avgdl = Entry(float, range=(0.0, None), allow_empty=True)
    # emb_list strategy fields (config.h BaseConfig tail; SURVEY Appendix A)
    emb_list_strategy = Entry(str, default="tokenann", stages=[Stage.TRAIN], allow_empty=True)
    retrieval_ann_ratio = Entry(float, default=1.0, range=(0.0, 100.0), stages=[Stage.SEARCH, Stage.RANGE_SEARCH], allow_empty=True)
    emb_list_rerank = Entry(bool, default=True, stages=[Stage.SEARCH], allow_empty=True)
    muvera_num_projections = Entry(int, default=8, range=(1, 32), stages=[Stage.TRAIN], allow_empty=True)
    muvera_num_repeats = Entry(int, default=10, range=(1, 256), stages=[Stage.TRAIN], allow_empty=True)
    muvera_seed = Entry(int, default=0, stages=[Stage.TRAIN], allow_empty=True)
    lemur_hidden_dim = Entry(int, default=128, range=(1, 65536), stages=[Stage.TRAIN], allow_empty=True)
    lemur_num_train_samples = Entry(int, default=10000, range=(1, None), stages=[Stage.TRAIN], allow_empty=True)
    lemur_num_epochs = Entry(int, default=10, range=(1, 10000), stages=[Stage.TRAIN], allow_empty=True)
    lemur_batch_size = Entry(int, default=256, range=(1, None), stages=[Stage.TRAIN], allow_empty=True)
    lemur_learning_rate = Entry(float, default=0.001, range=(0.0, 1.0), stages=[Stage.TRAIN], allow_empty=True)
    lemur_seed = Entry(int, default=0, stages=[Stage.TRAIN], allow_empty=True)
    lemur_num_layers = Entry(int, default=2, range=(1, 16), stages=[Stage.TRAIN], allow_empty=True)

    def check_and_adjust(self, stage: Stage) -> Tuple[Status, str]:
        if self.metric_type is not None:
            object.__setattr__(self, "metric_type", str(self.metric_type).upper())
        if stage & Stage.RANGE_SEARCH and self.radius is not None and self.range_filter is not None:
            pass  # per-metric range validity is checked at the call site
        return Status.success, ""

    # convenience used throughout the engine
    @property
    def metric(self) -> str:
        return (self.metric_type or "L2").upper()


class BruteForceConfig(BaseConfig):
    pass


def load_config(
    cfg_cls: Type[Config], json_cfg: Dict[str, Any], stage: Stage
) -> Tuple[Optional[Config], Status, str]:
    """Factory + load in one call (reference LoadConfig, src/index/index.cc:30-39)."""
    cfg = cfg_cls()
    st, msg = Config.load(cfg, json_cfg or {}, stage)
    if st != Status.success:
        return None, st, msg
    return cfg, Status.success, ""
