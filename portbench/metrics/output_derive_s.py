"""output_derive_s: the seconds an output event spends deriving its
fields (the program's ``hipims.output.derive`` spans, float64 numpy on the
host): their share of the profiled segment's ``hipims.output.event``
spans, times the mean event of the segment run without the profiler
(``output_event_s``'s clock), since the profiler slows the event's numpy
and zlib too, by about a tenth.  None where the program records neither
span."""

from portbench import spans


def read(ctx):
    return spans.share_of_event(ctx, "hipims.output.derive")
