"""The benchmark's general machinery: discovery by name, the timed and
traced windows, the trace reduction, the table of peaks."""
