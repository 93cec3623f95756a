"""System modules: what the benchmark runs for a configuration.

A configuration (``configs/<config>.json``) names its system in the key
``"system"``; ``system.module`` loads ``systems/<system>.py`` by that name,
as ``harness.reader`` loads a metric's file, and an unknown name fails with
the names that exist. A model is added as new files: a system module (with
any plain reference it calls), a configuration, mixes where it needs new
ones, and entries in ``BENCHMARK.json``. The harness, the loops, the check,
the control, the faults and the readers name no model and read no key of a
configuration but ``system``, ``name``, ``frame_hw``, ``input_frames``,
``pred_frames`` and ``limits``.

A system module gives:

``weight_groups(cfg) -> [(group, spec, dtype, stream), ...]``
    The parameters, in groups. ``spec`` lists ``(name, shape, kind)``;
    ``weights.make(module, cfg, seed, device)`` draws each group in one call
    on stream ``stream`` of the run's seed, shapes each parameter by its kind, rounds it to ``dtype``
    (a ``torch`` dtype's name) and returns ``{group: {name: float32
    tensor}}``, handed alike to ``build`` and ``reference``.

``KINDS`` (optional): ``{kind: f(v, shape) -> tensor}``, parameter kinds of
    the module's own beside ``weights._shape``'s, ``v`` being the standard
    normal draw of that parameter.

``build(cfg, kind, weights, device, wrap=None, control=False) -> System``
    The program under test for a ``kind`` ("batch" or "tick") mix:
    ``System.pipeline(params, frames) -> answer`` for a batch, and
    ``System.init(frames) -> state`` and ``System.step(params, state, frame)
    -> (state, answer)`` for a tick. Frames are uint8 numpy arrays in host
    memory, (B, T_in, C, H, W) or, a tick's new frame, (B, C, H, W); an
    answer is (B, T_out, C, H, W). ``System.params`` is handed back
    unchanged as the first argument of ``pipeline`` and ``step``.
    ``wrap(name, fn)``, where given, wraps each one-argument stage callable
    that the module names (the traced run opens the span ``nb.<name>``
    around it). ``control=True`` builds the module's own path in the
    precision below the one the configuration states: the control that the
    check has to find not correct. Import the program inside ``build``, so
    that the weights, the reference and the counts load without it.

``ANSWER``
    The name, as given to ``wrap``, of the stage that produces the answer;
    ``faults.altered_answer`` alters what it returns.

``reference(weights, cfg, frames, block) -> (answer, state)``
    The plain reference in float32 (the check turns TF32 off around it):
    uint8 frames (B, T_in, C, H, W) on the device -> the answer, and the
    state a tick holds after its last frame; ``block`` bounds the frames
    worked at a time. It imports nothing of the program and takes nothing
    that the program made. ``check.readings`` compares the answer
    (``frame_err``) and, in a tick, the state (``window_err``).

``call_cost(cfg, batch, frames_in_per_seq) -> costs.CallCost``
    One call's work counted from the configuration's shapes, for
    ``batch`` sequences that bring ``frames_in_per_seq`` new frames each
    (T_in for a batch call, 1 for a tick).

``nvcc_seconds() -> float`` (optional)
    Seconds this process spent building the program's kernels, for the
    set-up log.
"""
