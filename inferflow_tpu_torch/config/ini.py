"""Ini config parser with `${macro}` expansion.

reference: sslib ConfigData (3rd_party/sslib/config_data.h:17,53-77):
sections `[name]`, `key = value`, `;` comments, macro expansion from
predefined macros (`${data_root_dir}`, `${config_dir}`, `${model_name}`,
environment variables) and same-file keys.  Multi-line values continue
lines ending with a backslash or indented continuation of prompt templates;
the reference's prompt templates use `{\n}` escapes instead, which we keep.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

_MACRO_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigData:
    """Parsed ini file: section -> {key: raw value}, with GetItem-style
    accessors that expand macros on read."""

    def __init__(self, macros: Optional[Dict[str, str]] = None):
        self.sections: Dict[str, Dict[str, str]] = {}
        self.macros: Dict[str, str] = dict(macros or {})

    @classmethod
    def load(cls, path: str, macros: Optional[Dict[str, str]] = None
             ) -> "ConfigData":
        cfg = cls(macros)
        cfg.macros.setdefault("config_dir",
                              os.path.dirname(os.path.abspath(path)) + "/")
        cur = None
        with open(path, encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith((";", "#")):
                    continue
                if line.startswith("[") and line.endswith("]"):
                    cur = line[1:-1].strip()
                    cfg.sections.setdefault(cur, {})
                    continue
                if "=" in line and cur is not None:
                    key, _, val = line.partition("=")
                    cfg.sections[cur][key.strip()] = val.strip()
        return cfg

    # -- accessors -------------------------------------------------------
    def has_section(self, section: str) -> bool:
        return section in self.sections

    def section_names(self) -> List[str]:
        return list(self.sections)

    def expand(self, value: str, extra: Optional[Dict[str, str]] = None,
               section: Optional[str] = None, _depth: int = 0) -> str:
        if _depth > 8:
            return value

        def sub(m):
            name = m.group(1)
            if extra and name in extra:
                return extra[name]
            if name in self.macros:
                return self.macros[name]
            if section and name in self.sections.get(section, {}):
                return self.expand(self.sections[section][name], extra,
                                   section, _depth + 1)
            for sec in self.sections.values():
                if name in sec:
                    return self.expand(sec[name], extra, None, _depth + 1)
            return os.environ.get(name, m.group(0))

        return _MACRO_RE.sub(sub, value)

    def get(self, section: str, key: str, default: str = "",
            extra: Optional[Dict[str, str]] = None) -> str:
        raw = self.sections.get(section, {}).get(key)
        if raw is None:
            return default
        return self.expand(raw, extra, section)

    def get_int(self, section: str, key: str, default: int = 0, extra=None
                ) -> int:
        val = self.get(section, key, "", extra)
        try:
            return int(val)
        except ValueError:
            return default

    def get_float(self, section: str, key: str, default: float = 0.0,
                  extra=None) -> float:
        val = self.get(section, key, "", extra)
        try:
            return float(val)
        except ValueError:
            return default

    def get_bool(self, section: str, key: str, default: bool = False,
                 extra=None) -> bool:
        val = self.get(section, key, "", extra).lower()
        if val in ("true", "1", "yes", "on"):
            return True
        if val in ("false", "0", "no", "off"):
            return False
        return default

    def get_list(self, section: str, key: str, sep: str = ",", extra=None
                 ) -> List[str]:
        val = self.get(section, key, "", extra)
        return [p.strip() for p in val.split(sep) if p.strip()]

    def items(self, section: str, extra=None) -> Dict[str, str]:
        return {k: self.expand(v, extra, section)
                for k, v in self.sections.get(section, {}).items()}
