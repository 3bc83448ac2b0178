"""The general parts of the benchmark: finding a cell's files by name,
seeded weights and scenes, spans, the profiler's timeline, the result line."""
