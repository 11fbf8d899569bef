"""The port's telemetry plane: the cost model for now; its metrics, spans and
profiles wait for ``ROADMAP.md`` Queue 1 item 7."""
