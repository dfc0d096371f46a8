"""Types of the port that the ingest path needs (counterpart of
oramacore_tpu/types.py, whose names and behaviour these copies keep):
`Locale`, the reference's language list with its aliases, and
`parse_date_to_epoch_ms`, the date literal parser of date fields.
"""

from __future__ import annotations

from datetime import datetime, timezone
from enum import Enum
from typing import Any, Optional


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
