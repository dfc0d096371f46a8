"""Core typed DTOs of the port (counterpart of oramacore_tpu/types.py,
whose names and behaviour this copy keeps): ids and keys, `Locale`, the
number / date / geo filters and `WhereFilter`, the search modes, facets,
sort and group, `SearchParams`, `SearchResult` and its parts,
`EmbeddingFieldConfig`, `parse_date_to_epoch_ms`, `now_ms` and
`haversine_meters`.

Behavioral reference: oramacore `src/types.rs` (CollectionId :93,
DocumentId :112, FieldId :360, SearchParams :1381, SearchMode :925,
WhereFilter :1166, NumberFilter :2068, DateFilter :2134, GeoSearchFilter
:2216, FacetDefinition :828, SortBy :1360, GroupByConfig :1367,
Interaction :1623). The JSON wire shapes mirror the reference API; the
in-memory representation is our own.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Identifiers
# ---------------------------------------------------------------------------

_ID_RE = re.compile(r"^[a-zA-Z0-9_\-\.~]+$")


class InvalidIdError(ValueError):
    pass


def _check_id(value: str, kind: str) -> str:
    if not isinstance(value, str) or not value or not _ID_RE.match(value):
        raise InvalidIdError(f"invalid {kind}: {value!r}")
    return value


@dataclass(frozen=True, order=True)
class CollectionId:
    value: str

    def __post_init__(self):
        _check_id(self.value, "CollectionId")

    def __str__(self) -> str:
        return self.value


@dataclass(frozen=True, order=True)
class IndexId:
    value: str

    def __post_init__(self):
        _check_id(self.value, "IndexId")

    def __str__(self) -> str:
        return self.value


@dataclass(frozen=True, order=True)
class DocumentId:
    """Internal dense numeric document id (reference: types.rs:112)."""

    value: int

    def __str__(self) -> str:
        return str(self.value)


@dataclass(frozen=True, order=True)
class FieldId:
    value: int


class ApiKey:
    """Secret-redacting API key wrapper (reference: types.rs:549)."""

    __slots__ = ("_secret",)

    def __init__(self, secret: str):
        if not secret:
            raise ValueError("empty api key")
        self._secret = secret

    def expose(self) -> str:
        return self._secret

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ApiKey) and other._secret == self._secret

    def __hash__(self) -> int:
        return hash(self._secret)

    def __repr__(self) -> str:
        return "ApiKey(<redacted>)"


# ---------------------------------------------------------------------------
# Numbers (reference Number I32|F32, types.rs:1863)
# ---------------------------------------------------------------------------

Number = Union[int, float]


# ---------------------------------------------------------------------------
# Locales (subset of the reference's 33; en fully supported)
# ---------------------------------------------------------------------------

class Locale(str, Enum):
    EN = "english"
    IT = "italian"
    ES = "spanish"
    FR = "french"
    DE = "german"
    PT = "portuguese"
    NL = "dutch"
    SV = "swedish"
    DA = "danish"
    NO = "norwegian"
    FI = "finnish"
    RU = "russian"
    TR = "turkish"
    AR = "arabic"
    EL = "greek"
    HI = "hindi"
    JA = "japanese"
    KO = "korean"
    ZH = "chinese"
    # remaining reference locales (types.rs:369-436 LanguageDTO)
    BG = "bulgarian"
    ET = "estonian"
    GA = "irish"
    HU = "hungarian"
    HY = "armenian"
    ID = "indonesian"
    LT = "lithuanian"
    NE = "nepali"
    RO = "romanian"
    SA = "sanskrit"
    SL = "slovenian"
    SR = "serbian"
    TA = "tamil"
    UK = "ukrainian"
    # Fallback-tokenized locales
    OTHER = "other"

    @classmethod
    def parse(cls, v: Optional[str]) -> "Locale":
        if v is None:
            return cls.EN
        v = v.strip().lower()
        aliases = {
            "en": cls.EN, "english": cls.EN,
            "it": cls.IT, "italian": cls.IT,
            "es": cls.ES, "spanish": cls.ES,
            "fr": cls.FR, "french": cls.FR,
            "de": cls.DE, "german": cls.DE,
            "pt": cls.PT, "portuguese": cls.PT,
            "nl": cls.NL, "dutch": cls.NL,
            "sv": cls.SV, "swedish": cls.SV,
            "da": cls.DA, "danish": cls.DA,
            "no": cls.NO, "norwegian": cls.NO,
            "fi": cls.FI, "finnish": cls.FI,
            "ru": cls.RU, "russian": cls.RU,
            "tr": cls.TR, "turkish": cls.TR,
            "ar": cls.AR, "arabic": cls.AR,
            "el": cls.EL, "greek": cls.EL,
            "hi": cls.HI, "hindi": cls.HI,
            "ja": cls.JA, "japanese": cls.JA,
            "ko": cls.KO, "korean": cls.KO,
            "zh": cls.ZH, "chinese": cls.ZH,
            "bg": cls.BG, "bulgarian": cls.BG,
            "et": cls.ET, "estonian": cls.ET,
            "ga": cls.GA, "irish": cls.GA,
            "hu": cls.HU, "hungarian": cls.HU,
            "hy": cls.HY, "armenian": cls.HY,
            "id": cls.ID, "indonesian": cls.ID,
            "lt": cls.LT, "lithuanian": cls.LT,
            "ne": cls.NE, "nepali": cls.NE,
            "ro": cls.RO, "romanian": cls.RO,
            "sa": cls.SA, "sanskrit": cls.SA,
            "sl": cls.SL, "slovenian": cls.SL,
            "sr": cls.SR, "serbian": cls.SR,
            "ta": cls.TA, "tamil": cls.TA,
            "uk": cls.UK, "ukrainian": cls.UK,
        }
        return aliases.get(v, cls.OTHER)


# ---------------------------------------------------------------------------
# Filters (reference: WhereFilter types.rs:1166, Filter :761,
# NumberFilter :2068, DateFilter :2134, GeoSearchFilter :2150-2216)
# ---------------------------------------------------------------------------

@dataclass
class NumberFilter:
    op: str  # eq | gt | gte | lt | lte | between
    value: Union[Number, Tuple[Number, Number]]

    @classmethod
    def from_json(cls, raw: Any) -> "NumberFilter":
        if isinstance(raw, (int, float)) and not isinstance(raw, bool):
            return cls("eq", raw)
        if isinstance(raw, dict):
            if len(raw) != 1:
                raise ValueError(f"number filter must have exactly one op: {raw}")
            op, v = next(iter(raw.items()))
            if op == "between":
                if not (isinstance(v, list) and len(v) == 2):
                    raise ValueError("between expects [min, max]")
                return cls("between", (v[0], v[1]))
            if op not in ("eq", "gt", "gte", "lt", "lte"):
                raise ValueError(f"unknown number filter op: {op}")
            return cls(op, v)
        raise ValueError(f"invalid number filter: {raw!r}")


_DATE_FORMATS = (
    "%Y-%m-%dT%H:%M:%S.%f%z",
    "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S.%f",
    "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%d",
)


def parse_date_to_epoch_ms(raw: Any) -> int:
    """Parse a date literal (ISO-ish string or epoch number) to epoch millis.

    Reference stores dates as i64 (date_field.rs); accepts RFC3339 strings.
    """
    if isinstance(raw, bool):
        raise ValueError("bool is not a date")
    if isinstance(raw, (int, float)):
        return int(raw)
    if isinstance(raw, str):
        s = raw.strip()
        for fmt in _DATE_FORMATS:
            try:
                dt = datetime.strptime(s, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=timezone.utc)
                return int(dt.timestamp() * 1000)
            except ValueError:
                continue
        # try fromisoformat as a catch-all
        try:
            dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            pass
    raise ValueError(f"invalid date: {raw!r}")


@dataclass
class DateFilter:
    op: str  # eq | gt | gte | lt | lte | between
    value: Union[int, Tuple[int, int]]  # epoch millis

    @classmethod
    def from_json(cls, raw: Any) -> "DateFilter":
        if isinstance(raw, dict):
            if len(raw) != 1:
                raise ValueError(f"date filter must have exactly one op: {raw}")
            op, v = next(iter(raw.items()))
            if op == "between":
                return cls("between", (parse_date_to_epoch_ms(v[0]), parse_date_to_epoch_ms(v[1])))
            if op not in ("eq", "gt", "gte", "lt", "lte"):
                raise ValueError(f"unknown date filter op: {op}")
            return cls(op, parse_date_to_epoch_ms(v))
        return cls("eq", parse_date_to_epoch_ms(raw))


_GEO_UNIT_TO_METERS = {
    "m": 1.0,
    "km": 1000.0,
    "mi": 1609.344,
    "yd": 0.9144,
    "ft": 0.3048,
}


@dataclass
class GeoPoint:
    lat: float
    lon: float

    @classmethod
    def from_json(cls, raw: Any) -> "GeoPoint":
        if isinstance(raw, dict) and "lat" in raw and "lon" in raw:
            return cls(float(raw["lat"]), float(raw["lon"]))
        raise ValueError(f"invalid geopoint: {raw!r}")


@dataclass
class GeoRadiusFilter:
    center: GeoPoint
    radius_meters: float
    inside: bool = True


@dataclass
class GeoPolygonFilter:
    points: List[GeoPoint]
    inside: bool = True


GeoFilter = Union[GeoRadiusFilter, GeoPolygonFilter]


def geo_filter_from_json(raw: Any) -> GeoFilter:
    """Parse {"radius": {...}} or {"polygon": {...}} (types.rs:2150-2216)."""
    if not isinstance(raw, dict) or len(raw) != 1:
        raise ValueError(f"invalid geo filter: {raw!r}")
    kind, body = next(iter(raw.items()))
    if kind == "radius":
        unit = body.get("unit", "m")
        if unit not in _GEO_UNIT_TO_METERS:
            raise ValueError(f"unknown geo unit: {unit}")
        return GeoRadiusFilter(
            center=GeoPoint.from_json(body["coordinates"]),
            radius_meters=float(body["value"]) * _GEO_UNIT_TO_METERS[unit],
            inside=bool(body.get("inside", True)),
        )
    if kind == "polygon":
        pts = [GeoPoint.from_json(p) for p in body["coordinates"]]
        return GeoPolygonFilter(points=pts, inside=bool(body.get("inside", True)))
    raise ValueError(f"unknown geo filter kind: {kind}")


@dataclass
class FieldFilter:
    """Leaf filter on one field path."""

    path: str
    kind: str  # number | date | bool | string | geo
    payload: Any  # NumberFilter | DateFilter | bool | str|List[str] | GeoFilter


@dataclass
class WhereFilter:
    """Recursive and/or/not filter tree (reference WhereFilter types.rs:1166).

    JSON shape: {"field": <cond>, ..., "and": [...], "or": [...], "not": {...}}
    """

    conditions: List[FieldFilter] = field(default_factory=list)
    and_: List["WhereFilter"] = field(default_factory=list)
    or_: List["WhereFilter"] = field(default_factory=list)
    not_: Optional["WhereFilter"] = None

    def is_empty(self) -> bool:
        return not self.conditions and not self.and_ and not self.or_ and self.not_ is None

    @classmethod
    def from_json(cls, raw: Any) -> "WhereFilter":
        if raw is None:
            return cls()
        if not isinstance(raw, dict):
            raise ValueError(f"invalid where filter: {raw!r}")
        out = cls()
        for key, value in raw.items():
            if key == "and":
                out.and_ = [cls.from_json(v) for v in value]
            elif key == "or":
                out.or_ = [cls.from_json(v) for v in value]
            elif key == "not":
                out.not_ = cls.from_json(value)
            else:
                out.conditions.append(_parse_field_condition(key, value))
        return out


def _parse_field_condition(path: str, value: Any) -> FieldFilter:
    """Infer the leaf condition type from the JSON value shape."""
    if isinstance(value, bool):
        return FieldFilter(path, "bool", value)
    if isinstance(value, (int, float)):
        return FieldFilter(path, "number", NumberFilter.from_json(value))
    if isinstance(value, str):
        return FieldFilter(path, "string", value)
    if isinstance(value, list):
        if all(isinstance(v, str) for v in value):
            return FieldFilter(path, "string", value)
        raise ValueError(f"invalid filter list for {path}: {value!r}")
    if isinstance(value, dict):
        if "radius" in value or "polygon" in value:
            return FieldFilter(path, "geo", geo_filter_from_json(value))
        if len(value) == 1:
            op, v = next(iter(value.items()))
            if op in ("eq", "gt", "gte", "lt", "lte", "between"):
                # date vs number: strings inside → date
                probe = v[0] if isinstance(v, list) and v else v
                if isinstance(probe, str):
                    return FieldFilter(path, "date", DateFilter.from_json(value))
                return FieldFilter(path, "number", NumberFilter.from_json(value))
    raise ValueError(f"cannot parse filter condition for {path}: {value!r}")


# ---------------------------------------------------------------------------
# Search modes (reference SearchMode types.rs:925 — flattened serde)
# ---------------------------------------------------------------------------

DEFAULT_SIMILARITY = 0.7  # reference Similarity::default() (types.rs:881-885)


@dataclass
class FulltextMode:
    term: str
    threshold: Optional[float] = None
    exact: bool = False
    tolerance: Optional[int] = None


@dataclass
class VectorMode:
    term: str
    similarity: float = DEFAULT_SIMILARITY


@dataclass
class HybridMode:
    term: str
    similarity: float = DEFAULT_SIMILARITY
    threshold: Optional[float] = None
    exact: bool = False
    tolerance: Optional[int] = None


@dataclass
class AutoMode:
    term: str


SearchMode = Union[FulltextMode, VectorMode, HybridMode, AutoMode]


def search_mode_from_json(raw: Dict[str, Any]) -> Tuple[str, SearchMode]:
    """Parse the flattened mode+term fields of a search request.

    Mirrors the reference's custom Deserialize (types.rs:942-1010):
    mode defaults to "default" (fulltext semantics).
    """
    mode = raw.get("mode", "default")
    term = raw.get("term", "")
    if not isinstance(term, str):
        raise ValueError("'term' must be a string")
    similarity = float(raw.get("similarity", DEFAULT_SIMILARITY))
    threshold = raw.get("threshold")
    threshold = float(threshold) if threshold is not None else None
    exact = bool(raw.get("exact", False))
    tolerance = raw.get("tolerance")
    tolerance = int(tolerance) if tolerance is not None else None

    if mode in ("fulltext", "default"):
        return mode, FulltextMode(term, threshold, exact, tolerance)
    if mode == "vector":
        return mode, VectorMode(term, similarity)
    if mode == "hybrid":
        return mode, HybridMode(term, similarity, threshold, exact, tolerance)
    if mode == "auto":
        return mode, AutoMode(term)
    raise ValueError(f"unknown search mode: {mode}")


# ---------------------------------------------------------------------------
# Facets / sort / group (reference types.rs:828,1360,1367)
# ---------------------------------------------------------------------------

@dataclass
class NumberFacetRange:
    from_: Number
    to: Number


@dataclass
class FacetDefinition:
    kind: str  # number | bool | string
    ranges: List[NumberFacetRange] = field(default_factory=list)

    @classmethod
    def from_json(cls, raw: Any) -> "FacetDefinition":
        if not isinstance(raw, dict):
            raise ValueError(f"invalid facet definition: {raw!r}")
        # number: {"ranges": [...]}; bool: {"true": .., "false": ..};
        # string: any other map (reference types.rs:770-815)
        if "ranges" in raw:
            ranges = [NumberFacetRange(r["from"], r["to"]) for r in raw["ranges"]]
            return cls("number", ranges)
        if "true" in raw or "false" in raw:
            return cls("bool")
        return cls("string")


@dataclass
class SortBy:
    property: str
    order: str = "asc"  # asc | desc

    @classmethod
    def from_json(cls, raw: Any) -> "SortBy":
        if not isinstance(raw, dict) or "property" not in raw:
            raise ValueError(f"invalid sortBy: {raw!r}")
        order = str(raw.get("order", "asc")).lower()
        if order not in ("asc", "desc"):
            raise ValueError(f"invalid sort order: {order}")
        return cls(raw["property"], order)


@dataclass
class GroupByConfig:
    properties: List[str]
    max_results: int = 10

    @classmethod
    def from_json(cls, raw: Any) -> "GroupByConfig":
        if not isinstance(raw, dict) or "properties" not in raw:
            raise ValueError(f"invalid groupBy: {raw!r}")
        return cls(list(raw["properties"]), int(raw.get("maxResults", raw.get("max_results", 10))))


# ---------------------------------------------------------------------------
# SearchParams (reference types.rs:1381)
# ---------------------------------------------------------------------------

DEFAULT_LIMIT = 10


@dataclass
class SearchParams:
    mode: SearchMode
    mode_str: str = "default"
    limit: int = DEFAULT_LIMIT
    offset: int = 0
    boost: Dict[str, float] = field(default_factory=dict)
    properties: Optional[List[str]] = None  # None == '*'
    where: WhereFilter = field(default_factory=WhereFilter)
    facets: Dict[str, FacetDefinition] = field(default_factory=dict)
    indexes: Optional[List[IndexId]] = None
    sort_by: Optional[SortBy] = None
    group_by: Optional[GroupByConfig] = None
    user_id: Optional[str] = None
    # phrase adjacency boost (reference SearchParams phrase_boost knob,
    # string_field.rs API): docs containing the query tokens CONSECUTIVELY
    # get their adjacency bigrams scored with this extra weight
    phrase_boost: Optional[float] = None
    # force exact match counts on the pruned scoring tier (extension: the
    # dense path always counts exactly; pruned searches estimate unless
    # this or reader_side.pruned_exact_counts opts into the counting
    # dispatch — ops/pruned.py pruned_exact_counts)
    exact_count: bool = False

    @property
    def term(self) -> str:
        return self.mode.term

    @classmethod
    def from_json(cls, raw: Dict[str, Any]) -> "SearchParams":
        if not isinstance(raw, dict):
            raise ValueError("search params must be an object")
        mode_str, mode = search_mode_from_json(raw)
        props_raw = raw.get("properties")
        if props_raw is None or props_raw == "*":
            properties = None
        elif isinstance(props_raw, list):
            properties = [str(p) for p in props_raw]
        else:
            raise ValueError("properties must be '*' or a list of strings")
        facets = {
            name: FacetDefinition.from_json(d)
            for name, d in (raw.get("facets") or {}).items()
        }
        indexes_raw = raw.get("indexes")
        indexes = [IndexId(i) for i in indexes_raw] if indexes_raw is not None else None
        sort_raw = raw.get("sortBy") or raw.get("sort_by")
        group_raw = raw.get("groupBy") or raw.get("group_by")
        return cls(
            mode=mode,
            mode_str=mode_str,
            limit=int(raw.get("limit", DEFAULT_LIMIT)),
            offset=int(raw.get("offset", 0)),
            boost={k: float(v) for k, v in (raw.get("boost") or {}).items()},
            properties=properties,
            where=WhereFilter.from_json(raw.get("where")),
            facets=facets,
            indexes=indexes,
            sort_by=SortBy.from_json(sort_raw) if sort_raw else None,
            group_by=GroupByConfig.from_json(group_raw) if group_raw else None,
            user_id=raw.get("userID"),
            phrase_boost=(
                float(raw["phraseBoost"]) if raw.get("phraseBoost") is not None
                else float(raw["phrase_boost"]) if raw.get("phrase_boost") is not None
                else None
            ),
            exact_count=bool(
                raw.get("exactCount", raw.get("exact_count", False))
            ),
        )


# ---------------------------------------------------------------------------
# Search results (reference types.rs:1479-1522)
# ---------------------------------------------------------------------------

@dataclass
class SearchResultHit:
    id: str  # "index_id:doc_id_str"
    score: float
    document: Optional[Dict[str, Any]]

    def to_json(self) -> Dict[str, Any]:
        index_id = self.id.split(":", 1)[0] if ":" in self.id else ""
        return {
            "id": self.id,
            "index_id": index_id,
            "score": self.score,
            "document": self.document,
        }


@dataclass
class FacetResult:
    count: int
    values: Dict[str, int]

    def to_json(self) -> Dict[str, Any]:
        return {"count": self.count, "values": self.values}


@dataclass
class GroupedResult:
    values: List[Any]
    result: List[SearchResultHit]

    def to_json(self) -> Dict[str, Any]:
        return {"values": self.values, "result": [h.to_json() for h in self.result]}


@dataclass
class SearchResult:
    hits: List[SearchResultHit]
    count: int
    facets: Optional[Dict[str, FacetResult]] = None
    groups: Optional[List[GroupedResult]] = None
    # True when `count` is a union-probability ESTIMATE (the pruned
    # scoring tier — an exact corpus-wide count needs a full
    # aggregation). Additive field: absent/False on exact paths.
    count_estimated: bool = False

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "hits": [h.to_json() for h in self.hits],
            "count": self.count,
        }
        if self.count_estimated:
            out["count_estimated"] = True
        if self.facets is not None:
            out["facets"] = {k: v.to_json() for k, v in self.facets.items()}
        if self.groups is not None:
            out["groups"] = [g.to_json() for g in self.groups]
        return out


# ---------------------------------------------------------------------------
# Document field configuration (reference types.rs:519-524, 1745-1750)
# ---------------------------------------------------------------------------

class DocumentFields(str, Enum):
    ALL_STRING_PROPERTIES = "all_string_properties"
    AUTOMATIC = "automatic"
    PROPERTIES = "properties"  # carries a list


@dataclass
class EmbeddingFieldConfig:
    document_fields: DocumentFields = DocumentFields.ALL_STRING_PROPERTIES
    properties: List[str] = field(default_factory=list)
    model: str = "builtin-minihash-384"


# ---------------------------------------------------------------------------
# Interaction (answer API input, reference types.rs:1623)
# ---------------------------------------------------------------------------

@dataclass
class InteractionMessage:
    role: str  # user | assistant | system
    content: str


@dataclass
class Interaction:
    interaction_id: str
    query: str
    visitor_id: str = ""
    conversation_id: str = ""
    messages: List[InteractionMessage] = field(default_factory=list)
    system_prompt_id: Optional[str] = None
    llm_config: Optional[Dict[str, Any]] = None
    min_similarity: Optional[float] = None
    max_documents: Optional[int] = None
    ragat_notation: Optional[str] = None
    search_mode: Optional[str] = None
    related: Optional[Dict[str, Any]] = None

    @classmethod
    def from_json(cls, raw: Dict[str, Any]) -> "Interaction":
        msgs = [
            InteractionMessage(m.get("role", "user"), m.get("content", ""))
            for m in (raw.get("messages") or [])
        ]
        return cls(
            interaction_id=raw.get("interactionID", raw.get("interaction_id", "")),
            query=raw.get("query", ""),
            visitor_id=raw.get("visitorID", raw.get("visitor_id", "")),
            conversation_id=raw.get("conversationID", raw.get("conversation_id", "")),
            messages=msgs,
            system_prompt_id=raw.get("systemPromptID", raw.get("system_prompt_id")),
            llm_config=raw.get("llm_config"),
            min_similarity=raw.get("min_similarity"),
            max_documents=raw.get("max_documents"),
            ragat_notation=raw.get("ragat_notation"),
            search_mode=raw.get("searchMode", raw.get("search_mode")),
            related=raw.get("related"),
        )


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def now_ms() -> int:
    return int(time.time() * 1000)


def haversine_meters(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Great-circle distance used for geo radius filters."""
    r = 6371000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))
