"""Host utilities: the slope-method stage timer, the metric logger, device
traces and the stage timer, synthetic scenes, scan statistics."""
