"""Runtime: the offline decode pipeline and parameter loading."""
