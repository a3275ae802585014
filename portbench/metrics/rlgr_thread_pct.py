"""The host entropy coder's use of its thread pool (``native/rlgr.cpp``'s
batch calls), in %: the jobs' own nanoseconds (``rlgr_job_ns``, each
timed by its worker) over the pool's thread slots (``rlgr_thread_slots``:
each call's wall time times the threads it ran on), over the profiled
units. 100 is every thread coding for the whole call; less is threads
started, waiting for the last job, or without a job."""

from portbench import progtrace


def read(record):
    j, slots = progtrace.counter("rlgr_job_ns"), progtrace.counter("rlgr_thread_slots")
    return 100.0 * j / slots if j and slots else None
