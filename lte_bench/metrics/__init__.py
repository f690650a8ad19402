"""One reader per per-layer metric, `<metric>.py` with `read(ctx)`: the
metric's value from a traced stretch of batches, or None where the trace
holds nothing for it (the harness then leaves the metric out).

`ctx` has `trace` (`tracing.reduce`: kernels and device operations as
(name, start_s, end_s), `busy_s`, `window_s`, `batches`), `launches` (MAP
kernel launches over the stretch, from the program's counter), `cfg`,
`mix` and `link` (the configuration, the traffic mix, the link module)."""
