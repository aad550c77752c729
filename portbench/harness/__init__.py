"""The benchmark's own machinery: cell resolution, inputs from the seed, the
window's arithmetic, the profiler's reading, the roofline counts and the
comparisons that decide `correct`. It imports the program only where a mix
drives it."""
