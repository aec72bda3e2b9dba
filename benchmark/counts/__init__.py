"""FLOP and byte counts, and the published H100 peaks they are held
against: the yardstick of every roofline and `mfu` metric."""
