"""Scheduler internals: cache (assume protocol + incremental snapshot) and
the three-part scheduling queue (reference: pkg/scheduler/internal/)."""
