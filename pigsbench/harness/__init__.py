"""The harness: finding the parts by name, the timed window, the trace,
the yardstick's arithmetic and the comparison that decides `correct`."""
