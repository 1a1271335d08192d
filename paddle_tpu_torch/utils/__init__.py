"""Helpers of the port's device-side observability: the profiler trace
reader (:mod:`.profile_data`) and the measured per-kernel attribution
over it (:mod:`.device_trace`)."""
