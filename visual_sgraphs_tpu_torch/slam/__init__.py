"""Map state, frames, tracking (K6), mapping, keyframe program, system."""
