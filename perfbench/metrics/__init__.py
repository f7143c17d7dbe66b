"""One reader a metric: metrics/<name>.py defines read(run), which returns
the metric's value from a finished run (harness.Run) or None where the
run holds nothing to read it from (the harness then leaves the metric
out of the line)."""
