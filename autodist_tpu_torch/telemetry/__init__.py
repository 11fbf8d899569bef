"""The port's telemetry plane: the cost model and the histograms the
staleness controller keeps; its registry, spans and profiles wait for
``ROADMAP.md`` Queue 1 item 7."""
