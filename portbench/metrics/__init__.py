"""One reader a metric, named as the metric: ``read(run)`` returns its value,
or None where the run holds nothing for it to read."""
