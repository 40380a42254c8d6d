"""The port's ``train_lm`` example against the reference's
(``examples/train_lm.py``), on the CPU.

Its first steps match the reference's ``make_train_step`` loop without a
mesh (the reference's ``launch.train`` does not run in this container:
ROADMAP queue 3, caveat 4), from the reference's converted state, within
the training budget of ``tests/test_torch_planner.py`` (losses rel 5e-3,
state rtol 5e-3 / atol 5e-4); its restart resumes from the checkpoint
bitwise.  A file of its own: the ~100M-parameter config takes most of a
minute on one core.
"""
from __future__ import annotations

import numpy as np
import torch

import jax

from repro.training import data as jdata
from repro.training import train_step as jstep
from repro_torch import train_lm
from repro_torch.launch import train as tlaunch
from repro_torch.training import checkpoint
from repro_torch.training.tree import flatten
from test_torch_examples import assert_states_close, example, to_port

torch.set_num_threads(1)


def test_train_lm_first_steps_and_restart_match_reference(tmp_path,
                                                          monkeypatch):
    """``--steps 2 --demo-restart`` at batch 2 x 32 tokens: phase 1 trains
    step 0 and checkpoints, phase 2 resumes at step 1 from the checkpoint
    (the restored state bitwise phase 1's) and trains to 2.
    Both from the reference's state, against the reference's
    ``make_train_step`` loop with the same schedules and data."""
    midi = example("train_lm").midi_config()
    jstate = jstep.init_train_state(midi, jax.random.PRNGKey(0))
    monkeypatch.setattr(tlaunch, "init_train_state",
                        lambda cfg, gen: to_port(jstate))
    restored = []
    real_restore = checkpoint.restore

    def restore(*args, **kwargs):
        out = real_restore(*args, **kwargs)
        restored.append(out)
        return out
    monkeypatch.setattr(checkpoint, "restore", restore)

    runs = train_lm.run(steps=2, batch=2, seq=32, ckpt_dir=str(tmp_path),
                        demo_restart=True, device="cpu")
    (state1, losses1), (state2, losses2) = runs
    assert len(losses1) == 1 and len(losses2) == 1
    assert [at for _, at in restored] == [None, 1]
    back = restored[1][0]
    for a, b in zip(flatten(back)[1], flatten(state1)[1]):
        assert torch.equal(a, b)

    data = jdata.SyntheticDataConfig(vocab_size=midi.vocab_size, seq_len=32,
                                     global_batch=2, seed=0,
                                     input_kind=midi.input_kind,
                                     d_model=midi.d_model)
    want = []
    for total, span in ((1, range(0, 1)), (2, range(1, 2))):
        fn = jax.jit(jstep.make_train_step(midi, jstep.TrainHyper(
            total_steps=total, warmup=max(total // 10, 1),
            schedule="cosine", wsd_stable=int(total * 0.6),
            wsd_decay=int(total * 0.3))))
        for i in span:
            jstate, metrics = fn(jstate, jdata.synthetic_batch(data, i))
            want.append(float(metrics["loss"]))
        if total == 1:
            assert_states_close(state1, jstate)
    np.testing.assert_allclose(losses1 + losses2, want, rtol=5e-3)
    assert_states_close(state2, jstate)
    assert all(np.isfinite(losses1 + losses2))
