"""Stats sketches: mergeable summary statistics for cost-based planning
(the reference's ``Stat`` algebra, geomesa-utils/.../stats/Stat.scala)."""

from .stat import (
    BBoxStat,
    CountStat,
    DescriptiveStats,
    EnumerationStat,
    Frequency,
    GroupBy,
    Histogram,
    MinMax,
    SeqStat,
    Stat,
    TopK,
    Z3HistogramStat,
    parse_stat,
    stat_from_json,
)
