"""Space-filling-curve layer: dimension normalization, time binning,
morton interleaving on int64 tensors, the Z2 and Z3 curves, z-range
decomposition, and (in ``xz2`` / ``xz3``) the XZ curves of non-point
geometries."""

from .binnedtime import (
    BinnedTime,
    TimePeriod,
    bin_to_ms,
    from_binned_time,
    max_date_ms,
    max_offset,
    time_to_bin,
    to_binned_time,
)
from .normalize import NormalizedDimension, normalized_lat, normalized_lon, normalized_time
from .ranges import merge_ranges, zranges
from .sfc import Z2SFC, Z3SFC, z2_sfc, z3_sfc
from .zorder import (
    MAX_2D_BITS,
    MAX_3D_BITS,
    combine2,
    combine3,
    deinterleave2,
    deinterleave3,
    interleave2,
    interleave3,
    split2,
    split3,
)
