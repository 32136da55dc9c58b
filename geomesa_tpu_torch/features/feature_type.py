"""Feature type (schema) system.

Mirrors the capability of the reference's SimpleFeatureTypes spec strings
(geomesa-utils/.../geotools/SimpleFeatureTypes.scala; parser at
utils/.../sft/SimpleFeatureSpecParser.scala): a schema is declared as

    "name:String,age:Int,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval=week"

— comma-separated ``name:Type[:opt=val…]`` attributes, ``*`` marking the
default geometry, and trailing ``;key=value`` user-data options (index
configuration: ``geomesa.z3.interval``, ``geomesa.xz.precision``,
``geomesa.indices.enabled``, …).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["AttributeSpec", "FeatureType", "parse_spec"]

# canonical attribute type names (lower) → normalized name
_TYPES = {
    "string": "string",
    "int": "int", "integer": "int",
    "long": "long",
    "float": "float",
    "double": "double",
    "boolean": "bool", "bool": "bool",
    "date": "date", "timestamp": "date",
    "uuid": "string",
    "bytes": "bytes",
    "json": "json",
    "point": "point",
    "linestring": "linestring",
    "polygon": "polygon",
    "multipoint": "multipoint",
    "multilinestring": "multilinestring",
    "multipolygon": "multipolygon",
    "geometry": "geometry",
    "geometrycollection": "geometry",
}

GEOM_TYPES = {
    "point", "linestring", "polygon", "multipoint", "multilinestring",
    "multipolygon", "geometry",
}


@dataclass(frozen=True)
class AttributeSpec:
    name: str
    type: str                      # normalized type name
    options: dict = field(default_factory=dict)

    @property
    def is_geometry(self) -> bool:
        return self.type in GEOM_TYPES

    @property
    def indexed(self) -> bool:
        return str(self.options.get("index", "false")).lower() == "true"


@dataclass(frozen=True)
class FeatureType:
    name: str
    attributes: tuple            # tuple[AttributeSpec, ...]
    default_geom: str | None = None
    user_data: dict = field(default_factory=dict)

    def __post_init__(self):
        names = [a.name for a in self.attributes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute names in {names}")

    @property
    def attribute_names(self) -> list[str]:
        return [a.name for a in self.attributes]

    def attribute(self, name: str) -> AttributeSpec:
        for a in self.attributes:
            if a.name == name:
                return a
        raise KeyError(f"no attribute {name!r} in schema {self.name!r}")

    @property
    def geom_field(self) -> str | None:
        return self.default_geom

    @property
    def column_groups(self) -> dict:
        """Named attribute subsets from per-attribute ``column-groups``
        options (``|``-separated), the reference's ColumnGroups
        (index/conf/ColumnGroups.scala:27-78): queries hinting a group
        read only that group's columns.  The default geometry and dtg
        are members of every group (the reference always writes them to
        each column family)."""
        groups: dict = {}
        for a in self.attributes:
            raw = a.options.get("column-groups", "")
            for g in (x.strip() for x in raw.split("|") if x.strip()):
                groups.setdefault(g, []).append(a.name)
        if groups:
            always = [n for n in (self.default_geom, self.dtg_field) if n]
            for names in groups.values():
                for n in reversed(always):
                    if n not in names:
                        names.insert(0, n)
        return groups

    @property
    def dtg_field(self) -> str | None:
        """Default date attribute: explicit ``geomesa.index.dtg`` user-data
        or the first Date attribute (the reference's convention)."""
        explicit = self.user_data.get("geomesa.index.dtg")
        if explicit:
            return explicit
        for a in self.attributes:
            if a.type == "date":
                return a.name
        return None

    @property
    def z3_interval(self) -> str:
        return self.user_data.get("geomesa.z3.interval", "week")

    @property
    def xz_precision(self) -> int:
        return int(self.user_data.get("geomesa.xz.precision", 12))

    @property
    def enabled_indices(self) -> list[str] | None:
        """Explicit index list (``geomesa.indices.enabled``) or None for
        defaults-by-schema-shape."""
        raw = self.user_data.get("geomesa.indices.enabled")
        if not raw:
            return None
        return [s.strip() for s in raw.split(",") if s.strip()]

    @property
    def is_points(self) -> bool:
        return (
            self.default_geom is not None
            and self.attribute(self.default_geom).type == "point"
        )

    def spec_string(self) -> str:
        parts = []
        for a in self.attributes:
            star = "*" if a.name == self.default_geom else ""
            opts = "".join(f":{k}={v}" for k, v in a.options.items())
            type_name = {v: v for v in _TYPES.values()}[a.type]
            # canonical capitalization
            pretty = {
                "string": "String", "int": "Int", "long": "Long",
                "float": "Float", "double": "Double", "bool": "Boolean",
                "date": "Date", "bytes": "Bytes", "point": "Point",
                "linestring": "LineString", "polygon": "Polygon",
                "multipoint": "MultiPoint", "multilinestring": "MultiLineString",
                "multipolygon": "MultiPolygon", "geometry": "Geometry",
                "json": "Json",
            }[type_name]
            parts.append(f"{star}{a.name}:{pretty}{opts}")
        spec = ",".join(parts)
        if self.user_data:
            spec += ";" + ",".join(f"{k}={v}" for k, v in self.user_data.items())
        return spec


def _split_quoted(s: str, sep: str) -> list[str]:
    """Split on ``sep`` outside single-quoted runs (user-data list values
    are quoted in specs, e.g. ``geomesa.indices.enabled='z3,id'``)."""
    out, buf, quoted = [], [], False
    for ch in s:
        if ch == "'":
            quoted = not quoted
            buf.append(ch)
        elif ch == sep and not quoted:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return out


def parse_spec(name: str, spec: str) -> FeatureType:
    """Parse a spec string into a FeatureType."""
    spec = spec.strip()
    user_data: dict = {}
    if ";" in spec:
        spec, _, ud = spec.partition(";")
        for kv in _split_quoted(ud, ","):
            if not kv.strip():
                continue
            k, _, v = kv.partition("=")
            user_data[k.strip()] = v.strip().strip("'\"")

    attributes: list[AttributeSpec] = []
    default_geom = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        is_default = part.startswith("*")
        if is_default:
            part = part[1:]
        pieces = part.split(":")
        if len(pieces) < 2:
            raise ValueError(f"invalid attribute spec {part!r}")
        attr_name, type_name = pieces[0].strip(), pieces[1].strip().lower()
        if type_name not in _TYPES:
            raise ValueError(f"unknown attribute type {pieces[1]!r}")
        options = {}
        for opt in pieces[2:]:
            k, _, v = opt.partition("=")
            options[k.strip()] = v.strip()
        attr = AttributeSpec(attr_name, _TYPES[type_name], options)
        attributes.append(attr)
        if is_default:
            default_geom = attr_name
    if default_geom is None:
        for a in attributes:
            if a.is_geometry:
                default_geom = a.name
                break
    return FeatureType(name, tuple(attributes), default_geom, user_data)
