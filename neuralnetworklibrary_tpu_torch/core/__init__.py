"""Core training pieces: schedules, parameter helpers, layer-group
partition, optimizer and metrics."""
