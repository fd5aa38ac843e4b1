"""ORB front end: pyramid, FAST (K2), descriptors (K4), matcher (K5)."""
