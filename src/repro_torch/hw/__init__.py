"""``repro_torch.hw`` — heterogeneous per-site hardware profiles
(counterpart of ``repro.hw``)."""

from repro_torch.hw.profile import (
    DIGITAL,
    GEOMETRY_FIELDS,
    HEAD,
    Profile,
    Rule,
    SITE_CLASS,
    SiteSpecs,
    as_profile,
    check_band_geometry,
    fused_site_classes,
    geometry_key,
    site_class,
)

__all__ = [
    "DIGITAL",
    "GEOMETRY_FIELDS",
    "HEAD",
    "Profile",
    "Rule",
    "SITE_CLASS",
    "SiteSpecs",
    "as_profile",
    "check_band_geometry",
    "fused_site_classes",
    "geometry_key",
    "site_class",
]
