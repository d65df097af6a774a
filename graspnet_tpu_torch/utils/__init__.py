"""Host utilities: the slope-method stage timer of the timing entry points."""
